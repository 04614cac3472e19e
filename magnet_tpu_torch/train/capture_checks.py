"""Stand-ins that check captured chunks (``Trainer.step_capture``) against
the same steps run otherwise.  ``chip_smoke.py`` runs them on the card and
the CPU tests on the CPU; the trainer never does.

``EagerStep`` takes the capture's place and runs every step eagerly;
``grown_bucket_fit_rank`` is ``parallel.launch.fit_rank`` with one rank's
edge buckets grown mid-fit, so that rank captures anew while the others
replay.
"""
from magnet_tpu_torch.ops.graph import EDGE_BUCKET
from magnet_tpu_torch.parallel.launch import fit_rank
from magnet_tpu_torch.train.trainer import Trainer


class EagerStep:
    """``Trainer.step_capture`` run eagerly: the warm-up and every replay
    run ``Trainer.device_step`` on the chunk's (padded) batch and graph,
    the capture nothing: the steps a captured chunk replays, without the
    CUDA graph."""

    @staticmethod
    def warm_up(trainer, batch, graph):
        return trainer.device_step(batch, graph)

    def __init__(self, trainer, batch, graph):
        self.trainer = trainer

    def replay(self, batch, graph):
        return self.trainer.device_step(batch, graph)


def grown_bucket_fit_rank(rank: int, world: int, spec: dict) -> dict:
    """``fit_rank`` with rank ``spec["grow_rank"]``'s edge buckets (None: no
    rank's) grown by one ``EDGE_BUCKET`` before its second padded chunk:
    its graphs take another signature there, so it warms up and captures
    anew while the other ranks replay."""
    padded, chunks = Trainer._padded, []

    def grown(self, graphs):
        chunks.append(len(graphs))
        if rank == spec.get("grow_rank") and len(chunks) == 2:
            for role in self.buckets.edges:
                self.buckets.edges[role] += EDGE_BUCKET
        return padded(self, graphs)

    Trainer._padded = grown
    try:
        return fit_rank(rank, world, spec)
    finally:
        Trainer._padded = padded
