"""Numerical constants (counterpart of craytracer_tpu/constants.py:1-56).

Only the values the port reads are copied; they are the same numbers as
the JAX package's, so both packages round identically.
"""

import numpy as np

# Ray-intersection epsilon (reference util/constants.h:45).
K_EPSILON = 7.0e-6

# Finite f32 miss sentinel (craytracer_tpu/constants.py:17).
TMAX = float(np.float32(3.4028235e38))

# The disk light's jittered up vector (constants.py:45).
JITTERED_UP = (0.0072, 1.0, 0.0034)

PI = float(np.pi)
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

# Named conductor IOR presets, (eta, k) per RGB channel
# (constants.py:47-56, materials.cpp:5-20).
METAL_PRESETS = {
    "GOLD": ((0.14282006, 0.37414363, 1.43944442),
             (3.90463543, 2.44763327, 2.13765264)),
    "SILVER": ((0.154935181, 0.116475478, 0.138087392),
               (4.81810093, 3.11561656, 2.1424017)),
    "BERYLLIUM": ((4.17617416, 3.1783011, 2.77819276),
                  (3.82729554, 3.00373626, 2.86292768)),
    "CHROMIUM": ((4.36040831, 2.9105196, 1.65118635),
                 (5.19538164, 4.22238398, 3.74699736)),
    "CESIUM": ((2.14034843, 1.69870293, 1.65889668), (0.0, 0.0, 0.0)),
    "COPPER": ((0.19999069, 0.92208463, 1.09987593),
               (3.90463543, 2.44763327, 2.13765264)),
    "MERCURY": ((2.39383841, 1.43696785, 0.907622635),
                (6.31419611, 4.36266136, 3.41453838)),
}
