"""Golden spec model: pure-Python-int re-statement of the reference semantics.

Everything here is the oracle the device code is tested against, and also
serves as the host-side verifier implementation.  Pure Python and numpy.
"""
