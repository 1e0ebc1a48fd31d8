"""NumPy oracle of the reference Patchwork++ semantics (port of
``patchworkpp_tpu/oracle``).

A test reference that runs on the CPU on every machine: the port's engines
are held against it on the CPU and on the card, and it is held against the
golden per-point index sets captured from the compiled C++ reference
(golden/reference_ground_indices.npz).
"""

from patchworkpp_tpu_torch.oracle.numpy_oracle import NumpyPatchworkpp

__all__ = ["NumpyPatchworkpp"]
