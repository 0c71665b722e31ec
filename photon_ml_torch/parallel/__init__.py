"""The fused GAME training program (``parallel/distributed.py``) on one
device or over a data-axis mesh of ranks (``parallel/mesh.py``,
``parallel/multihost.py``, ``parallel/sharded_dense.py``,
``parallel/scoring.py``); counterpart of ``photon_ml_tpu/parallel``. The
model axis and partitioned I/O are not ported yet (ROADMAP.md item 15)."""
