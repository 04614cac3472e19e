from setuptools import setup, find_packages

setup(
    name="magnet_tpu",
    version="0.1.0",
    packages=find_packages(include=["magnet_tpu*"]),
    # the port builds its CUDA kernels from these sources at first use
    package_data={"magnet_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
)
