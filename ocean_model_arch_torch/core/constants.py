"""Physical constants of the model (the port's own copy of
``ocean_model_arch_tpu/core/constants.py``).

Mirrors the subset of shared/constants.f90 that the
shallow-water + tracer code paths actually consume (FreeFallAcc, RadEarth,
EarthAngVel, pi variants, lat_extr, bottom-friction parameters). The
reference stores most of these as single precision (wp4); we keep exact
float32 values where the reference arithmetic is float32 so that metric
fields match bit-for-bit in the f64-state/f32-metric validation mode.
"""

import numpy as np

# Double-precision pi (reference constants.f90:14-15)
DPI = 3.14159265358979
DPIP180 = DPI / 180.0

# Single-precision pi as the reference defines it (constants.f90:11-12)
PI_F32 = np.float32(3.1415926)
PIP180_F32 = np.float32(PI_F32 / np.float32(180.0))

# Latitude clamp used by the metric/geo transforms (constants.f90:17)
LAT_EXTR = 89.99999

# Earth / water constants (constants.f90:19-29); f32 in the reference.
RAD_EARTH = np.float32(6371000.0)        # Earth radius [m]
EARTH_ANG_VEL = np.float32(7.2921159e-5)  # Earth angular velocity [rad/s]
HEAT_CAP_WATER = np.float32(4000.0)       # heat capacity of water [J/kg/degC]
REF_DEN = np.float32(1025.0)              # reference density [kg/m^3]
FREE_FALL_ACC = np.float32(9.8)           # gravitational acceleration [m/s^2]
DEN_FRESH = np.float32(1000.0)            # fresh water density [kg/m^3]

# Bottom friction parameters (constants.f90:116-131)
TYPE_FRIC = 2          # 0 - none, 1 - linear, 2 - nonlinear
CB_L = np.float32(5e-4)       # linear bottom friction coefficient [m/s]
CB_NL = np.float32(2.5e-3)    # nonlinear bottom friction coefficient
EBOTTOM = np.float32(25.0e-4)  # bottom turbulent kinetic energy [(m/s)^2]
