"""Model analysis: parameter counts and FLOP counts (port of ``utils/analysis.py``).

Replaces detectron2's ``utils/analysis.py`` (fvcore ``FlopCountAnalysis``)
and HRNet's ``get_model_summary`` (``lib/utils/utils.py:87-203``).
Parameters are read under their Flax names (``convert.module_to_flax``), so
the counts and the table's rows are the JAX package's. FLOPs come from
PyTorch's ``FlopCounterMode`` over one call, where the JAX package reads
XLA's cost analysis of the compiled call; the two counts differ by
construction (see :func:`flops_of`).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..convert import module_to_flax


def _params(params: Any) -> Mapping:
    """A module's ``params`` tree under its Flax names, or the tree as given."""
    return module_to_flax(params)["params"] if isinstance(params, torch.nn.Module) else params


def _leaves(tree: Mapping, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """The leaves in ``jax.tree_util``'s order: every dict's keys sorted."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def parameter_count(params: Any) -> int:
    """The number of parameters of a module (its Flax ``params``) or of a ``params`` tree."""
    return int(sum(np.prod(x.shape) for _, x in _leaves(_params(params))))


def parameter_count_table(params: Any, depth: int = 1) -> str:
    """Grouped parameter counts, detectron2-style table, of a module or a ``params`` tree."""
    groups: dict[str, int] = {}
    for path, leaf in _leaves(_params(params)):
        key = "/".join(path[:depth])
        groups[key] = groups.get(key, 0) + int(np.prod(leaf.shape))
    total = sum(groups.values())
    lines = [f"{'module':40s} {'#params':>12s}"]
    for k in sorted(groups, key=groups.get, reverse=True):
        lines.append(f"{k:40s} {groups[k]:12,d}")
    lines.append(f"{'TOTAL':40s} {total:12,d}")
    return "\n".join(lines)


def flops_of(fn: Callable, *example_args) -> dict[str, float]:
    """Run ``fn(*example_args)`` once under ``torch.utils.flop_counter.FlopCounterMode``
    and return ``{"flops": total}``.

    PyTorch's counter covers matmuls and convolutions (2 a multiply-add),
    not elementwise work, and a convolution counts every tap of its
    window, the zero padding's included, which is what the card's
    implicit-GEMM convolutions compute. XLA's cost analysis, which the JAX
    package returns, counts a padded convolution's in-bounds taps only and
    the elementwise operations too, and adds byte keys ("bytes accessed",
    ...) that have no counterpart here. The two agree on a matmul and on
    an unpadded convolution.
    """
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return {"flops": float(counter.get_total_flops())}


def model_summary(model: torch.nn.Module, example_input: torch.Tensor, train: bool = False) -> str:
    """Param count + forward FLOPs one-liner (get_model_summary). The
    forward runs without gradients in train or eval mode as asked; the
    modules' modes and buffers (BatchNorm statistics) are restored after."""
    n = parameter_count(model)
    modes = {mod: mod.training for mod in model.modules()}
    buffers = {name: b.detach().clone() for name, b in model.named_buffers()}
    try:
        model.train(train)
        with torch.no_grad():
            flops = flops_of(model, example_input)["flops"]
    except Exception:
        flops = float("nan")
    finally:
        for mod, mode in modes.items():
            mod.training = mode
        with torch.no_grad():
            for name, b in model.named_buffers():
                b.copy_(buffers[name])
    return (
        f"params: {n / 1e6:.2f}M  "
        f"forward flops: {flops / 1e9:.2f} GFLOP  "
        f"input: {tuple(example_input.shape)}"
    )
