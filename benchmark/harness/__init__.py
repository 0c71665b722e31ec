"""The benchmark's own machinery: finding cells by name, the measured window,
the profiler trace, the roofline arithmetic and the result line.

Nothing here imports ``photon_ml_torch`` at module level; the kinds under
``traffic/`` drive the program, and the references under ``reference/``
never import it.
"""
