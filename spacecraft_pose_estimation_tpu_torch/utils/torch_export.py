"""The port's HRNet back to the reference's torch names (port of ``utils/torch_export.py``).

The reference stacks consume torch state dicts; a landmark model trained
by the port, exported under the reference's naming, runs under the
reference's own ``landmark_regression/tools/test.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import module_to_flax


def export_hrnet(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """:func:`hrnet_flax_to_torch` of the port's HRNet module, as contiguous
    float32 CPU tensors (what ``torch.save`` writes to the ``.pth``)."""
    tree = module_to_flax(model)
    sd = hrnet_flax_to_torch(tree["params"], tree["batch_stats"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def hrnet_flax_to_torch(params, stats) -> dict[str, np.ndarray]:
    """The inverse of ``torch_import.hrnet_torch_to_flax``'s name grammar:
    an HRNet's ``params`` / ``batch_stats`` trees -> a reference
    ``pose_hrnet`` state dict (``lib/models/pose_hrnet.py`` module names):
    the trunk and ``final_layer``. The CMS heads are not exported, as in the
    JAX package.
    """

    sd = {}

    def conv_t(k):
        return np.transpose(k, (3, 2, 0, 1))  # HWIO -> OIHW

    def emit_convbn(prefix_conv, prefix_bn, node, bn_stats):
        sd[prefix_conv + ".weight"] = conv_t(np.asarray(node["conv"]["kernel"]))
        sd[prefix_bn + ".weight"] = np.asarray(node["bn"]["scale"])
        sd[prefix_bn + ".bias"] = np.asarray(node["bn"]["bias"])
        sd[prefix_bn + ".running_mean"] = np.asarray(bn_stats["bn"]["mean"])
        sd[prefix_bn + ".running_var"] = np.asarray(bn_stats["bn"]["var"])

    def emit_block(tprefix, node, snode):
        for k in node:
            if k.startswith("conv"):
                i = k[-1]
                emit_convbn(f"{tprefix}.conv{i}", f"{tprefix}.bn{i}", node[k], snode[k])
            elif k == "down":
                sd[f"{tprefix}.downsample.0.weight"] = conv_t(np.asarray(node[k]["conv"]["kernel"]))
                sd[f"{tprefix}.downsample.1.weight"] = np.asarray(node[k]["bn"]["scale"])
                sd[f"{tprefix}.downsample.1.bias"] = np.asarray(node[k]["bn"]["bias"])
                sd[f"{tprefix}.downsample.1.running_mean"] = np.asarray(snode[k]["bn"]["mean"])
                sd[f"{tprefix}.downsample.1.running_var"] = np.asarray(snode[k]["bn"]["var"])

    for name, node in params.items():
        snode = stats.get(name, {})
        if name in ("stem1", "stem2"):
            i = name[-1]
            emit_convbn(f"conv{i}", f"bn{i}", node, snode)
        elif name == "layer1":
            for bk, bnode in node.items():
                emit_block(f"layer1.{bk.removeprefix('block')}", bnode, snode[bk])
        elif name.startswith("transition"):
            s = name.removeprefix("transition")
            for k, sub in node.items():
                if k.startswith("adapt"):
                    i = k.removeprefix("adapt")
                    emit_convbn(f"transition{s}.{i}.0", f"transition{s}.{i}.1", sub, snode[k])
                else:  # new{i}_{j}
                    i, j = k.removeprefix("new").split("_")
                    emit_convbn(
                        f"transition{s}.{i}.{j}.0", f"transition{s}.{i}.{j}.1", sub, snode[k]
                    )
        elif name.startswith("stage"):
            m = name.split("_m")
            s, mod = m[0].removeprefix("stage"), m[1]
            for k, sub in node.items():
                if k.startswith("branch"):
                    b = k.removeprefix("branch")
                    for bk, bnode in sub.items():
                        emit_block(
                            f"stage{s}.{mod}.branches.{b}.{bk.removeprefix('block')}",
                            bnode,
                            snode[k][bk],
                        )
                elif k == "fuse":
                    for fk, fnode in sub.items():
                        if fk.startswith("up"):
                            i, j = fk.removeprefix("up").split("_")
                            emit_convbn(
                                f"stage{s}.{mod}.fuse_layers.{i}.{j}.0",
                                f"stage{s}.{mod}.fuse_layers.{i}.{j}.1",
                                fnode,
                                snode[k][fk],
                            )
                        else:  # down{i}_{j}_{k}
                            i, j, kk = fk.removeprefix("down").split("_")
                            emit_convbn(
                                f"stage{s}.{mod}.fuse_layers.{i}.{j}.{kk}.0",
                                f"stage{s}.{mod}.fuse_layers.{i}.{j}.{kk}.1",
                                fnode,
                                snode[k][fk],
                            )
        elif name == "final_layer":
            sd["final_layer.weight"] = conv_t(np.asarray(node["kernel"]))
            sd["final_layer.bias"] = np.asarray(node["bias"])
    return sd
