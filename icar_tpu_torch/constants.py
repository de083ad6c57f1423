"""Copy of icar_tpu/constants.py, kept identical by tests/test_torch_setup.py.

Physical and model constants for the TPU-native ICAR rebuild.

Values mirror the reference model's constants module
(src/constants/icar_constants.f90:389-420) so that physics
parity tests against the reference are meaningful.  Scheme-selection enums
mirror icar_constants.f90:340-377.
"""

# --- physical constants (icar_constants.f90:389-420) ---
LH_VAPORIZATION = 2.26e6     # J/kg latent heat of vaporization
RD = 287.058                 # J/(kg K) specific gas constant, dry air
RW = 461.5                   # J/(kg K) specific gas constant, water vapor
CP = 1012.0                  # J/kg/K specific heat capacity of moist STP air
GRAVITY = 9.81               # m/s^2
PI = 3.1415927
STEFAN_BOLTZMANN = 5.67e-8   # W/m^2/K^4
KARMAN = 0.41                # von Karman constant
SOLAR_CONSTANT = 1366.0      # W/m^2
P0 = 100000.0                # reference pressure for the Exner function [Pa]

ROVCP = RD / CP
ROVG = RD / GRAVITY

# latent heat as a function of temperature (WRF-style)
XLV0 = 3.15e6
XLV1 = 2370.0
XLS0 = 2.905e6
XLS1 = 259.532

# saturated vapor pressure parameters
SVP1 = 0.6112
SVP2 = 17.67
SVP3 = 29.65
SVPT0 = 273.15

EP1 = RW / RD - 1.0
EP2 = RD / RW

SMALL_VALUE = 1e-6           # kSMALL_VALUE (icar_constants.f90:326)
FREEZING_POINT = 273.15      # K

DEG2RAD = 0.017453293        # wind.f90:27

# --- physics scheme selection enums (icar_constants.f90:340-377) ---
# microphysics
MP_NONE = 0
MP_THOMPSON = 1
MP_SIMPLE = 2            # SB04
MP_MORRISON = 3
MP_WSM6 = 4
MP_THOMPSON_AER = 5
MP_WSM3 = 6

# advection
ADV_NONE = 0
ADV_UPWIND = 1
ADV_MPDATA = 2

# wind solvers (icar_constants kCONSERVE_MASS etc.)
WIND_NONE = 0
WIND_LINEAR = 1          # linear mountain-wave theory
WIND_CONSERVE_MASS = 2   # terrain-ratio acceleration
WIND_ITERATIVE = 3       # divergence-minimizing iteration
WIND_LINEAR_ITERATIVE = 5

# planetary boundary layer
PBL_NONE = 0
PBL_BASIC = 1
PBL_SIMPLE = 2           # local-K diffusion (Louis 1979 / HP96)
PBL_YSU = 3

# radiation
RA_NONE = 0
RA_BASIC = 1             # use forcing SW/LW
RA_SIMPLE = 2            # empirical clear-sky + cloud fraction
RA_RRTMG = 3

# land surface
LSM_NONE = 0
LSM_BASIC = 1            # prescribed fluxes from forcing
LSM_SIMPLE = 2
LSM_NOAH = 3
LSM_NOAHMP = 4

# open water
WATER_NONE = 0
WATER_BASIC = 1
WATER_SIMPLE = 2
WATER_LAKE = 3

# convection / cumulus
CU_NONE = 0
CU_TIEDTKE = 1
CU_SIMPLE = 2
CU_KF = 3
CU_NSAS = 4
CU_BMJ = 5

# default halo width (icar_constants.f90:320); MPDATA needs 2
DEFAULT_HALO_SIZE = 1

# maximum internal physics timestep [s] (time_step.f90:421)
MAX_DT = 120.0

VERSION_STRING = "2.1-tpu"
