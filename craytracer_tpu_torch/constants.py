"""Numerical constants (counterpart of craytracer_tpu/constants.py:1-56).

Only the values the Cornell slice reads are ported; they are the same
numbers as the JAX package's, so both packages round identically.
"""

import numpy as np

# Ray-intersection epsilon (reference util/constants.h:45).
K_EPSILON = 7.0e-6

# Finite f32 miss sentinel (craytracer_tpu/constants.py:17).
TMAX = float(np.float32(3.4028235e38))

INV_PI = float(1.0 / np.pi)
TWO_PI = float(2.0 * np.pi)

# Preset colors accepted by the scene grammar (constants.py:30-41).
PRESET_COLORS = {
    "RED": (1.0, 0.0, 0.0),
    "GREEN": (0.0, 1.0, 0.0),
    "BLUE": (0.0, 0.0, 1.0),
    "WHITE": (1.0, 1.0, 1.0),
    "BLACK": (0.0, 0.0, 0.0),
    "YELLOW": (1.0, 1.0, 0.0),
    "CYAN": (0.0, 1.0, 1.0),
    "PINK": (1.0, 0.0, 1.0),
    "GREY": (0.5, 0.5, 0.5),
    "MED_ORCHID": (0.729, 0.333, 0.827),
}
