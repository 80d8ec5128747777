"""fedicra_torch: FedICRA in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``fedicra_tpu`` that imports no JAX. Module names mirror the JAX
package; tensors at the public functions keep its NHWC layout. Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
