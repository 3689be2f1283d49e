"""landmarks_ms.fps: ``landmarks_ms`` (its reader, ``landmarks_ms.py``) in the cells where it moves
``frames_per_s``, as they report no ``clip_ms_p95``."""

import runpy
from pathlib import Path

read = runpy.run_path(str(Path(__file__).with_name("landmarks_ms.py")))["read"]
