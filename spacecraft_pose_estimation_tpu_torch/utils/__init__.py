"""Shared utilities (port of ``utils/``).

* ``logger`` (``setup_logger``, the HRNet output tree), ``env`` (seeding,
  an environment report), ``collect_env`` (the full report, ``python -m``),
  ``registry``, ``serialize`` (cloudpickle wrappers), ``file_io``
  (``PathManager`` with ``zip://`` and ``spe://``), ``zipreader``,
  ``memory`` (``retry_if_oom``), ``analysis`` (parameter tables, FLOP
  counts), ``vis`` (debug images, box and track overlays);
* weight files in and out: ``torch_import`` and ``zoo_import`` (reference
  ``.pth`` and zoo ``.pkl`` checkpoints onto the port's modules) and
  ``torch_export`` (back to a reference ``.pth``).

The JAX package's ``utils/platform.py`` has no counterpart: it exists to
override JAX's platform plugin, a job that ``device.resolve_device`` and
every command's ``--device`` do here.
"""
