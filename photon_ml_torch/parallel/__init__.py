"""The fused GAME training program (``parallel/distributed.py``) on one
device or over a ("data", "model") mesh of ranks (``parallel/mesh.py``,
``parallel/multihost.py``, ``parallel/sharded_dense.py``,
``parallel/column_sharded.py``, ``parallel/scoring.py``); counterpart of
``photon_ml_tpu/parallel``."""
