"""ceph_tpu_torch — the PyTorch/CUDA port of ceph_tpu's device data plane
(erasure coding, deep scrub, CRUSH placement, compression and dedup
fingerprints), for one NVIDIA H100.

``ceph_tpu`` (JAX on a TPU) stays the reference: every module here
mirrors a module there by name and is held byte-for-byte against it by
``tests/test_torch_*.py``.  Each device program on the data path is a
CUDA kernel written by hand (``csrc/``), built at first use by
``kernels/build.py`` and bound with ``ctypes``; beside each kernel sits
its plain PyTorch version, which runs for tensors on the CPU.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; with no card and no such request they raise.
"""
