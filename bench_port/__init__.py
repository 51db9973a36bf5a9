"""The benchmark of ``neuralsim_tpu_torch`` on one NVIDIA H100: one cell
per run (``run.py``), everything of a cell found by name under this folder."""
