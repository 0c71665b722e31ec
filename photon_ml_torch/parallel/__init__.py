"""The fused GAME training program (``parallel/distributed.py``), on one
device; counterpart of ``photon_ml_tpu/parallel``. The mesh, its input
layout and multi-process runs are not ported yet (ROADMAP.md item 10,
step 2, with item 15)."""
