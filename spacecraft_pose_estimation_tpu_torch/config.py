"""The experiment config tree and its presets (a copy of the JAX package's ``config.py``).

One frozen-dataclass tree (``ExperimentConfig``) with dotted ``KEY VALUE``
override lists (:func:`apply_overrides`, the reference's CLI ``opts``), YAML
files of the same keys (:func:`load_yaml`) and the named presets
(:func:`get_preset`), the linear scaling rule (:func:`auto_scale_workers`)
and the LazyConfig nodes (:class:`LazyCall`, :func:`instantiate`) that
``tools.lazyconfig_train`` reads. PyYAML is imported only to read a YAML
file or an override that gives a sequence as text.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any


def _replace_path(cfg, dotted: str, value):
    """Immutable update of a nested dataclass field by dotted path."""
    head, _, rest = dotted.partition(".")
    head_l = head.lower()
    if not hasattr(cfg, head_l):
        raise KeyError(f"unknown config key: {head}")
    if rest:
        sub = _replace_path(getattr(cfg, head_l), rest, value)
        return dataclasses.replace(cfg, **{head_l: sub})
    current = getattr(cfg, head_l)
    return dataclasses.replace(cfg, **{head_l: _coerce(value, current)})


def _coerce(value, current):
    if isinstance(current, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    if isinstance(current, int) and not isinstance(current, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, (tuple, list)):
        if isinstance(value, str):
            import yaml  # only for a sequence given as text, e.g. "[25, 35]"

            value = yaml.safe_load(value)
        return tuple(value)
    return value


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str = "pose_hrnet"
    num_joints: int = 17
    image_size: tuple[int, int] = (512, 512)  # (w, h)
    heatmap_size: tuple[int, int] = (128, 128)
    sigma: float = 2.0
    sigma2: float = 4.0
    sigma3: float = 3.0
    sigma4: float = 2.0
    multi_scale_target: bool = False
    init_weights: bool = True
    pretrained: str = ""
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class LossCfg:
    use_ohkm: bool = False
    topk: int = 8
    use_target_weight: bool = True


@dataclasses.dataclass(frozen=True)
class DatasetCfg:
    root: str = ""
    dataset: str = "events"
    data_dir: str = ""
    train_set: str = "train"
    test_set: str = "test"
    image_width: int = 1280
    image_height: int = 720
    flip: bool = False
    scale_factor: float = 0.25
    rot_factor: float = 30.0
    # half-body crop augmentation (JointsDataset.py:155-162); default-off
    # in every reference spacecraft config (default.py:81-82, prob 0.0)
    # and the spacecraft datasets define no body split (events.py:35-36)
    num_joints_half_body: int = 8
    prob_half_body: float = 0.0
    upper_body_ids: tuple = ()
    color_rgb: bool = True
    # adversarial twins (train_da_ms.py)
    root_adversarial: str = ""
    dataset_adversarial: str = ""
    train_set_adversarial: str = ""


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    batch_size_per_chip: int = 24
    batch_size_adversarial: int = 3
    begin_epoch: int = 0
    end_epoch: int = 40
    optimizer: str = "adam"
    lr: float = 0.001
    lr_factor: float = 0.1
    lr_step: tuple[int, ...] = (25, 35)
    wd: float = 0.0001
    momentum: float = 0.9
    nesterov: bool = False
    shuffle: bool = True
    auto_resume: bool = True
    # checkpoint every N epochs (the reference saves every epoch —
    # lib/utils/utils.py save_checkpoint per train.py:183-211 — which is
    # the parity default; the best/ checkpoint and the final save are
    # unconditional, so raising this only thins the periodic snapshots)
    checkpoint_period: int = 1
    # adversarial
    d_loss_mode: int = 1
    beta: float = 0.0002
    # world-size scaling (detectron2 SOLVER.REFERENCE_WORLD_SIZE)
    reference_world_size: int = 0


@dataclasses.dataclass(frozen=True)
class TestCfg:
    batch_size_per_chip: int = 16
    flip_test: bool = False
    post_process: bool = True
    shift_heatmap: bool = True
    model_file: str = ""
    model_files_ensemble: tuple[str, ...] = ()
    blur_kernel: int = 11


@dataclasses.dataclass(frozen=True)
class DebugCfg:
    debug: bool = False
    save_batch_images_gt: bool = False
    save_batch_images_pred: bool = False
    save_heatmaps_gt: bool = False
    save_heatmaps_pred: bool = False


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    output_dir: str = "output"
    log_dir: str = "log"
    print_freq: int = 20
    seed: int = 0
    model: ModelCfg = ModelCfg()
    loss: LossCfg = LossCfg()
    dataset: DatasetCfg = DatasetCfg()
    train: TrainCfg = TrainCfg()
    test: TestCfg = TestCfg()
    debug: DebugCfg = DebugCfg()


def apply_overrides(cfg: ExperimentConfig, opts: list[str]) -> ExperimentConfig:
    """``KEY VALUE`` pair list, e.g. ["TRAIN.LR", "0.01"] (update_config)."""
    if len(opts) % 2:
        raise ValueError("opts must be KEY VALUE pairs")
    for key, value in zip(opts[::2], opts[1::2]):
        cfg = _replace_path(cfg, key, value)
    return cfg


def load_yaml(cfg: ExperimentConfig, path: str) -> ExperimentConfig:
    """Merge a YAML file of dotted or nested keys into the config; keys the
    tree does not have are skipped, as the JAX loader skips the reference
    yaml's keys it folds elsewhere."""
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(f"reading the config file {path} needs PyYAML, which is not installed") from e
    with open(path) as f:
        tree = yaml.safe_load(f) or {}

    def walk(prefix, node):
        for k, v in node.items():
            dotted = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                yield from walk(dotted, v)
            else:
                yield dotted, v

    for dotted, v in walk("", tree):
        try:
            cfg = _replace_path(cfg, dotted, v)
        except KeyError:
            continue
    return cfg


def auto_scale_workers(cfg: ExperimentConfig, world_size: int) -> ExperimentConfig:
    """The linear scaling rule (detectron2 ``engine/defaults.py:633``): when
    ``train.reference_world_size`` is set and differs from ``world_size``,
    the learning rate scales by world_size / reference_world_size."""
    ref = cfg.train.reference_world_size
    if ref == 0 or ref == world_size:
        return cfg
    train = dataclasses.replace(cfg.train, lr=cfg.train.lr * (world_size / ref), reference_world_size=world_size)
    return dataclasses.replace(cfg, train=train)


def instantiate(node: Any):
    """Build objects from {"_target_": "pkg.mod.Obj" or a callable, ...}
    nodes, depth first (detectron2's LazyConfig ``instantiate``); other
    dicts, lists and tuples are rebuilt with their items instantiated."""
    if isinstance(node, dict):
        built = {k: instantiate(v) for k, v in node.items() if k != "_target_"}
        if "_target_" not in node:
            return built
        target = node["_target_"]
        if isinstance(target, str):
            module, _, name = target.rpartition(".")
            target = getattr(importlib.import_module(module), name)
        return target(**built)
    if isinstance(node, (list, tuple)):
        return type(node)(instantiate(v) for v in node)
    return node


class LazyCall:
    """``LazyCall(Obj)(a=1)`` -> the node {"_target_": Obj, "a": 1} that
    :func:`instantiate` calls (detectron2 ``config/lazy.py``)."""

    def __init__(self, target):
        self._target = target

    def __call__(self, **kwargs):
        return {"_target_": self._target, **kwargs}


# ---------------------------------------------------------------------------
# Preset registry (the reference's experiment matrix)
# ---------------------------------------------------------------------------

_PRESETS: dict[str, ExperimentConfig] = {}


def register_preset(name: str, cfg: ExperimentConfig) -> None:
    _PRESETS[name] = cfg


def get_preset(name: str) -> ExperimentConfig:
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(_PRESETS)}")
    return _PRESETS[name]


def list_presets() -> list[str]:
    return sorted(_PRESETS)


# events-config.yaml: pose_hrnet 512^2 -> 128^2, sigma 2, adam 1e-3, 40 ep
register_preset(
    "events",
    ExperimentConfig(
        model=ModelCfg(name="pose_hrnet", num_joints=17, image_size=(512, 512),
                       heatmap_size=(128, 128), sigma=2.0),
        dataset=DatasetCfg(dataset="events", image_width=1280, image_height=720),
        train=TrainCfg(batch_size_per_chip=24, end_epoch=40, lr_step=(25, 35)),
        test=TestCfg(batch_size_per_chip=16, flip_test=False, post_process=True),
    ),
)

# lit_hpc_*: hrnet_cms 768^2 -> 768^2 multi-scale, sigmas 12/10/8/6, DA
register_preset(
    "lightbox_cms",
    ExperimentConfig(
        model=ModelCfg(name="hrnet_cms", num_joints=11, image_size=(768, 768),
                       heatmap_size=(768, 768), sigma=12.0, sigma2=10.0,
                       sigma3=8.0, sigma4=6.0, multi_scale_target=True),
        dataset=DatasetCfg(dataset="lightbox", image_width=1920, image_height=1200),
        train=TrainCfg(batch_size_per_chip=2, end_epoch=60, d_loss_mode=2, beta=2e-4),
    ),
)

# sun_hpc_*: hrnet_cms_384 768^2 -> 384^2, sigmas 6/5/4/3
register_preset(
    "sunlamp_cms",
    ExperimentConfig(
        model=ModelCfg(name="hrnet_cms_384", num_joints=11, image_size=(768, 768),
                       heatmap_size=(384, 384), sigma=6.0, sigma2=5.0,
                       sigma3=4.0, sigma4=3.0, multi_scale_target=True),
        dataset=DatasetCfg(dataset="sunlamp", image_width=1920, image_height=1200),
        train=TrainCfg(batch_size_per_chip=2, end_epoch=60, d_loss_mode=2, beta=2e-4),
    ),
)
