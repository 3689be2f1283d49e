"""Desktop-integration helpers for the v2e CLI (headless-safe).

The reference vendors Paul Boddie's LGPL ``desktop`` package
(v2ecore/desktop/: 1,193 LoC of 2005-era desktop-environment detection
and window enumeration) solely to call ``desktop.open(output_folder)``
at the end of a run (v2e.py:805), plus a plyer notification
(v2e.py:793-798).

A copy of the JAX package's ``events/desktop.py``: the same behavioral
surface on the stdlib:

* ``get_desktop()`` — detect the desktop environment (the subset of
  environments the vendored module detects that still exist),
* ``is_standard()`` — True when DESKTOP_LAUNCH is set (the proposed
  DESKTOP_LAUNCH standard the vendored module implements),
* ``open(path_or_url, desktop=None, wait=False)`` — open a resource
  with the environment's opener,
* ``notify(title, message)`` — best-effort desktop notification.

All helpers are no-ops (with a log line) on headless hosts — the
common case on a compute server — and never raise: the reference call sites
wrap them in try/except and only log failures.
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
import sys

logger = logging.getLogger(__name__)


def get_desktop() -> str | None:
    """Best-effort desktop-environment detection (desktop/__init__.py
    get_desktop semantics on current systems)."""
    env = os.environ
    if sys.platform == "darwin":
        return "Mac OS X"
    if sys.platform in ("win32", "cygwin"):
        return "Windows"
    if not (env.get("DISPLAY") or env.get("WAYLAND_DISPLAY")):
        return None  # headless
    xdg = env.get("XDG_CURRENT_DESKTOP", "").split(":")[0]
    if xdg:
        return xdg
    if env.get("KDE_FULL_SESSION"):
        return "KDE"
    if env.get("GNOME_DESKTOP_SESSION_ID"):
        return "GNOME"
    return "X11"


def is_standard() -> bool:
    """True when the DESKTOP_LAUNCH opener override is configured."""
    return "DESKTOP_LAUNCH" in os.environ


def _opener_argv(desktop_name: str | None) -> list[str] | None:
    if is_standard():
        return shlex.split(os.environ["DESKTOP_LAUNCH"])
    if desktop_name == "Mac OS X":
        return ["open"]
    if desktop_name == "Windows":
        return ["cmd", "/c", "start", ""]
    if desktop_name == "KDE":
        return ["kde-open"]
    if desktop_name == "GNOME":
        return ["gio", "open"]
    if desktop_name is not None:
        return ["xdg-open"]
    return None


def open(path_or_url: str, desktop: str | None = None, wait: bool = False):  # noqa: A001 — the reference API name
    """Open a file/folder/URL in the desktop environment; silently a
    no-op when headless (v2e.py:802-808 wraps this in try/except and
    only logs)."""
    d = desktop or get_desktop()
    argv = _opener_argv(d)
    if argv is None:
        logger.info("headless host: not opening %s", path_or_url)
        return None
    try:
        proc = subprocess.Popen(
            argv + [path_or_url],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        if wait:
            proc.wait()
        return proc.pid
    except OSError as e:
        logger.warning("could not open %s: %s", path_or_url, e)
        return None


def notify(title: str, message: str) -> bool:
    """Best-effort desktop notification (the reference uses plyer,
    v2e.py:793-798). Uses notify-send when present; returns success."""
    if get_desktop() in (None, "Windows", "Mac OS X"):
        logger.info("notification: %s — %s", title, message)
        return False
    try:
        subprocess.run(
            ["notify-send", title, message],
            check=True,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            timeout=5,
        )
        return True
    except Exception:
        logger.info("notification: %s — %s", title, message)
        return False
