"""Data and graph parallelism on ``torch.distributed`` (counterpart of
``magnet_tpu/parallel/``): the (dp, graph) process mesh (``mesh``), the
edge-partitioned graph and its processors (``graph_partition``), and a
multi-rank launcher for tests and smoke runs (``launch``)."""
