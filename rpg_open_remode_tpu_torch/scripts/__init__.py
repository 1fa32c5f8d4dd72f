"""Measurement scripts of the port (counterparts of the repository's
``scripts_profile_update.py``, ``scripts_profile_match.py`` and
``scripts/roofline.py``), each run as ``python -m
rpg_open_remode_tpu_torch.scripts.<name>``; nothing on the engine's path
imports this package."""
