"""Environment report for bug reports and run provenance (port of
``utils/collect_env.py``, detectron2's ``utils/collect_env.py``): library
versions, the CUDA devices, the process group and the environment
variables that steer PyTorch on the card.

    python -m spacecraft_pose_estimation_tpu_torch.utils.collect_env
"""

from __future__ import annotations

import importlib
import os
import sys


def _power_limit(index: int) -> str:
    """The card's power limit in W, read through ctypes from NVML
    (``libnvidia-ml``, NVIDIA's management library), or why it cannot be read."""
    import ctypes

    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
        handle, milliwatts = ctypes.c_void_p(), ctypes.c_uint()
        for call in (lambda: nvml.nvmlInit_v2(),
                     lambda: nvml.nvmlDeviceGetHandleByIndex_v2(index, ctypes.byref(handle)),
                     lambda: nvml.nvmlDeviceGetPowerManagementLimit(handle, ctypes.byref(milliwatts))):
            rc = call()
            if rc:
                return f"unavailable (NVML error {rc})"
        return f"{milliwatts.value / 1000:.2f} W"
    except OSError as e:  # pragma: no cover - environment dependent
        return f"unavailable ({e})"


def collect_env_info() -> str:
    rows: list[tuple[str, str]] = []
    rows.append(("sys.platform", sys.platform))
    rows.append(("Python", sys.version.replace("\n", "")))

    for mod in ("torch", "numpy", "cv2", "scipy", "pandas"):
        try:
            m = importlib.import_module(mod)
            rows.append((mod, getattr(m, "__version__", "unknown")))
        except Exception as e:  # pragma: no cover - environment dependent
            rows.append((mod, f"unavailable ({type(e).__name__})"))

    try:
        import torch
        import torch.distributed as dist

        rows.append(("torch.version.cuda", str(torch.version.cuda)))
        cuda = torch.cuda.is_available()
        rows.append(("cudnn", str(torch.backends.cudnn.version()) if cuda else "none"))
        n = torch.cuda.device_count() if cuda else 0
        rows.append(("devices", f"{n} x {torch.cuda.get_device_name(0)}" if n else "none"))
        if n:
            rows.append(("capability", ".".join(map(str, torch.cuda.get_device_capability(0)))))
            rows.append(("power limit", _power_limit(0)))
        if dist.is_available() and dist.is_initialized():
            rows.append(("rank", str(dist.get_rank())))
            rows.append(("world_size", str(dist.get_world_size())))
    except Exception as e:  # pragma: no cover
        rows.append(("torch runtime", f"unavailable ({type(e).__name__}: {e})"))

    for var in ("CUDA_VISIBLE_DEVICES", "PYTORCH_CUDA_ALLOC_CONF", "TORCH_CUDA_ARCH_LIST"):
        if os.environ.get(var):
            rows.append((f"env:{var}", os.environ[var]))

    width = max(len(k) for k, _ in rows)
    return "\n".join(f"{k.ljust(width)}  {v}" for k, v in rows)


if __name__ == "__main__":
    print(collect_env_info())
