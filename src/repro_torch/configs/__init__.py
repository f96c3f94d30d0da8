"""One config module per assigned architecture (+ the paper's own).

Each module exports CONFIG (the exact published dims) and REDUCED (a
same-family small config for CPU smoke tests).
"""
