"""Result containers with detectron2's ``structures`` surface (port of ``structures.py``).

The port computes with padded tensors and a ``valid`` mask; :class:`Boxes`
and :class:`Instances` wrap them with the reference's methods
(``structures/boxes.py``, ``instances.py``) without ragged data.
``Instances`` has a fixed capacity: ``valid`` marks the live rows.
"""

from __future__ import annotations

from typing import Any

import torch

from .ops import boxes as box_ops

Tensor = torch.Tensor


class Boxes:
    """(N, 4) XYXY boxes."""

    def __init__(self, tensor: Tensor):
        self.tensor = tensor

    def area(self) -> Tensor:
        return box_ops.box_area(self.tensor)

    def clip(self, height: float, width: float) -> "Boxes":
        return Boxes(box_ops.clip_boxes(self.tensor, height, width))

    def nonempty(self, threshold: float = 0.0) -> Tensor:
        return box_ops.nonempty_mask(self.tensor, threshold)

    def iou(self, other: "Boxes") -> Tensor:
        return box_ops.pairwise_iou(self.tensor, other.tensor)

    def __len__(self) -> int:
        return self.tensor.shape[0]


class Instances:
    """One image's predictions at a fixed capacity: named fields with a
    common leading dim and the (N,) bool ``valid`` mask of the live rows."""

    def __init__(self, fields: dict[str, Tensor], valid: Tensor):
        self.fields, self.valid = fields, valid

    @classmethod
    def create(cls, valid: Tensor, **fields: Tensor) -> "Instances":
        n = valid.shape[0]
        for k, v in fields.items():
            if v.shape[0] != n:
                raise ValueError(f"field {k!r} leading dim {v.shape[0]} != {n}")
        return cls(dict(fields), valid)

    def get(self, name: str) -> Tensor:
        return self.fields[name]

    def has(self, name: str) -> bool:
        return name in self.fields

    def num_instances(self) -> Tensor:
        return self.valid.sum()

    def masked(self, name: str, fill=0) -> Tensor:
        """The field with its padding rows set to ``fill``."""
        v = self.fields[name]
        mask = self.valid.reshape((-1,) + (1,) * (v.dim() - 1))
        return torch.where(mask, v, torch.as_tensor(fill, dtype=v.dtype, device=v.device))

    def to_numpy(self) -> dict[str, Any]:
        """The live rows of every field as numpy arrays on the host."""
        keep = self.valid.cpu().numpy()
        return {k: v.detach().cpu().numpy()[keep] for k, v in self.fields.items()}


def instances_from_detections(dets: dict) -> list[Instances]:
    """Padded (B, D, ...) detector output -> one :class:`Instances` an image
    (``boxes``, ``scores``, ``classes``)."""
    return [Instances.create(dets["valid"][i], boxes=dets["boxes"][i], scores=dets["scores"][i],
                             classes=dets["classes"][i])
            for i in range(dets["valid"].shape[0])]
