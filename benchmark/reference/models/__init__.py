"""The reference's model families, one module a family, found by name.

A configuration's ``model`` names ``reference/models/<model>.py``. A model
module gives:

- ``param_specs(config)``: (name, shape, fan_in) of every parameter, the
  port's names; ``harness.inputs.draw_weights`` draws them;
- ``port_kwargs(config)``: the port's ``net_factory`` keywords that its
  ``widths`` set (the task's channels and classes are the driver's);
- ``forward(config, params, images, client, generator, round_bits=None)``:
  the train-mode forward over a flat parameter dict, NHWC in and out; a
  dict with ``logits`` and whatever else the objective reads (``aux``, the
  deep-supervision outputs the tree term reads; ``heatmap``, the PCS
  heatmap the contrast term reads);
- ``convs(config)``: (name, C_in, C_out, kernel, output pixels, groups) of
  every convolution one image's forward runs, in the order it runs them;
  ``name`` is the prefix of the convolution's weight leaf (``<name>.weight``);
- ``is_head(name)``: the out conv's leaves, which FedICRA's head phase
  trains alone;

and, where the family has them:

- ``is_pcs(name)``: leaves that never train (personalised channel selection);
- ``is_dsn_head(name)``: leaves that train only while a loss reads them (the
  deep-supervision heads, read by the tree term);
- ``HEATMAP = True``: the forward is client-conditioned and gives
  ``heatmap``, so FedICRA adds its contrast term;
- ``CONSTANT_INPUT``: names of convolutions whose input does not depend on
  the image (no input gradient is computed for them).
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType

MODELS = Path(__file__).resolve().parent


def load(model: str) -> ModuleType:
    """The module ``reference/models/<model>.py``."""
    path = MODELS / f"{model}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference model module for model {model!r} at {path}")
    return importlib.import_module(f"{__name__}.{model}")


def never(name: str) -> bool:
    return False
