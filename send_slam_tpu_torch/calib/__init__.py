"""Calibration persistence (``io.py``), the part of the JAX package's
``calib/`` the server reads; the calibration pipeline itself is not
ported yet."""
