"""The run's environment: caches inside the checkout, precision, isolation."""

from __future__ import annotations

import os
import sys
from pathlib import Path

# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "fedicra_tpu")


def prepare(root: Path) -> None:
    """Point every build and kernel cache at a fixed directory inside the
    checkout (the port's own nvcc builds go to ``fedicra_torch/_build``, a
    fixed path inside it too), and keep libraries from loading JAX. Call
    before torch is imported."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        (cache / sub).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def set_precision(precision: dict) -> None:
    """Set both TF32 switches from a precision file
    (``precisions/<name>.json``) before the port runs: TF32 is a
    per-process setting that the port leaves at PyTorch's defaults."""
    import torch

    torch.backends.cudnn.allow_tf32 = bool(precision["allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(precision["allow_tf32"])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)
