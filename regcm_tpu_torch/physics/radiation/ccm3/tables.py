"""CCM3 radiation scheme constants and spectral tables.

Scientific parameter tables of the NCAR CCM3 radiation package as
embedded in the reference (``Main/radlib/mod_rad_radiation.F90:400-592``
data statements, ``radini`` :752-852 derived coefficients, cgs unit
constants from ``Share/mod_constants.F90:341-356``).  Values are
physical-parameterization constants (Slingo 1989 liquid-cloud optics,
Ebert & Curry 1992 ice optics, Ramanathan & Downey 1986 H2O
emissivity/absorptivity fits, Kiehl & Briegleb 1991 CO2 bands) — not
code.
"""
from __future__ import annotations

import numpy as np

from ....utils import constants as c

# cgs conversions (Share/mod_constants.F90:341-356)
EGRAVGTS = c.egrav * 100.0
REGRAVGTS = 1.0 / EGRAVGTS
CPDGTS = c.cpd * 1.0e4
GOCP = EGRAVGTS / CPDGTS
SSLP = c.stdp * 10.0                 # dynes/cm^2
RSSLP = 1.0 / SSLP
STEBOL = 5.67e-8 * 1000.0            # sigm*d_1000 (cgs)
RGSSLP = 0.5 / (EGRAVGTS * SSLP)
DPFCO2 = 5.0e-3
DPFO3 = 2.5e-3

# molecular weights (Share/mod_constants.F90)
AMD = 28.9644
AMW = 18.0153
AMCO2 = 44.0100
AMO3 = 47.9942
AMCH4 = 16.0430
AMN2O = 44.0128
AMCFC11 = 137.3686
AMCFC12 = 120.9140

EP2 = AMW / AMD
REPSIL = 1.0 / EP2

# far-wing correction constants (R&D 1986)
FWCOEF = 0.1
FWC1 = 0.30
FWC2 = 4.5
FC1 = 2.6

R80257 = 1.0 / 8.0257e-4
R293 = 1.0 / 293.0
R250 = 1.0 / 250.0
R3205 = 1.0 / 0.3205
R300 = 1.0 / 300.0
R2SSLP = 1.0 / (2.0 * SSLP)
R296 = 1.0 / 296.0

# ozone path constants
V0 = 22.4136
P0 = 0.1 * SSLP
CPLOS = V0 / (AMD * c.egrav) * 100.0
CPLOL = V0 / (AMD * c.egrav * P0) * 0.5 * 100.0

DELTA = 1.70e-3
O2MMR = 0.23143
TRMIN = 1.0e-3
WRAY = 0.999999
GRAY = 0.0
FRAY = 0.1
VERYNEARONE = 0.999999
MXARG = 25.0

NSPI = 19

# A. Slingo (1989) liquid cloud optics, 4 bands
ABARL = np.array([2.817e-2, 2.682e-2, 2.264e-2, 1.281e-2])
BBARL = np.array([1.305, 1.346, 1.454, 1.641])
CBARL = np.array([-5.62e-8, -6.94e-6, 4.64e-4, 0.201])
DBARL = np.array([1.63e-8, 2.35e-5, 1.24e-3, 7.56e-3])
EBARL = np.array([0.829, 0.794, 0.754, 0.826])
FBARL = np.array([2.482e-3, 4.226e-3, 6.56e-3, 4.353e-3])

# Ebert & Curry (1992) ice cloud optics
ABARI = np.array([3.448e-3] * 4)
BBARI = np.array([2.431] * 4)
CBARI = np.array([1.0e-5, 1.1e-4, 1.861e-2, 0.46658])
DBARI = np.array([0.0, 1.405e-5, 8.328e-4, 2.05e-5])
EBARI = np.array([0.7661, 0.7730, 0.7940, 0.9595])
FBARI = np.array([5.851e-4, 5.665e-4, 7.267e-4, 1.076e-4])

FRCSOL = np.array([0.001488, 0.001389, 0.001290, 0.001686, 0.002877,
                   0.003869, 0.026336, 0.360739, 0.065392, 0.526861,
                   0.526861, 0.526861, 0.526861, 0.526861, 0.526861,
                   0.526861, 0.006239, 0.001834, 0.001834])

NIRWGT = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.320518,
                   1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0])

WAVMIN = np.array([0.200, 0.245, 0.265, 0.275, 0.285, 0.295, 0.305,
                   0.350, 0.640, 0.700, 0.701, 0.701, 0.701, 0.701,
                   0.702, 0.702, 2.630, 4.160, 4.160])
WAVMAX = np.array([0.245, 0.265, 0.275, 0.285, 0.295, 0.305, 0.350,
                   0.640, 0.700, 5.000, 5.000, 5.000, 5.000, 5.000,
                   5.000, 5.000, 2.860, 4.550, 4.550])

V_RAYTAU_35 = 0.155208
V_RAYTAU_64 = 0.0392
V_ABO3_35 = 2.4058030e+1
V_ABO3_64 = 2.210e+1

RAYTAU = np.array([4.020, 2.180, 1.700, 1.450, 1.250, 1.085, 0.730,
                   V_RAYTAU_35, V_RAYTAU_64, 0.020, 0.0001, 0.0001,
                   0.0001, 0.0001, 0.0001, 0.0001, 0.0001, 0.0001,
                   0.0001])

ABH2O = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.002,
                  0.035, 0.377, 1.950, 9.400, 44.600, 190.000, 0.0,
                  0.0, 0.0])
ABO3 = np.array([5.370e4, 13.080e4, 9.292e4, 4.530e4, 1.616e4, 4.441e3,
                 1.775e2, V_ABO3_35, V_ABO3_64, 0.0, 0.0, 0.0, 0.0, 0.0,
                 0.0, 0.0, 0.0, 0.0, 0.0])
ABCO2 = np.array([0.0] * 16 + [0.094, 0.196, 1.963])
ABO2 = np.array([0.0] * 8 + [1.11e-5, 6.69e-5] + [0.0] * 9)

PH2O = np.array([0.0] * 9 + [0.505, 0.210, 0.120, 0.070, 0.048, 0.029,
                 0.018, 0.0, 0.0, 0.0])
PCO2 = np.array([0.0] * 16 + [1.000, 0.640, 0.360])
PO2 = np.array([0.0] * 8 + [1.000, 1.000] + [0.0] * 9)

# spectral-interval index for cloud particle properties (Slingo eq 1-3,
# radcsw mod_rad_radiation.F90:1420-1430), precomputed per interval
# (0-based band index)
INDXSL = np.zeros(NSPI, np.int64)
for _ns in range(NSPI):
    if WAVMAX[_ns] <= 0.70:
        INDXSL[_ns] = 0
    elif abs(WAVMIN[_ns] - 0.700) < 1e-12:
        INDXSL[_ns] = 1
    elif abs(WAVMIN[_ns] - 0.701) < 1e-12:
        INDXSL[_ns] = 2
    elif abs(WAVMIN[_ns] - 0.702) < 1e-12 or WAVMIN[_ns] > 2.38:
        INDXSL[_ns] = 3

# H2O emissivity/absorptivity coefficient tables (coefa..coefk; column
# major data statements in the reference → (rows, 4|2) here)
COEFA = np.array([[1.01400, 6.41695e-3, 2.85787e-5],
                  [1.01320, 6.86400e-3, 2.96961e-5],
                  [1.02920, 1.01680e-2, 5.30226e-5],
                  [1.02743, 9.85113e-3, 5.00233e-5]]).T
COEFB = np.array([[8.85675, -3.51620e-2, 2.38653e-4, -1.71439e-6],
                  [5.73841, -1.91919e-2, 1.65993e-4, -1.54665e-6],
                  [6.64034, 1.56651e-2, -9.73357e-5, 0.0],
                  [7.09281, 1.40056e-2, -1.15774e-4, 0.0]]).T
COEFC = np.array([[9.90127e-1, 1.22475e-3, 4.90135e-6],
                  [9.89753e-1, 1.97081e-3, 3.42046e-6],
                  [9.75230e-1, 1.03341e-3, 0.0],
                  [9.77366e-1, 8.60014e-4, 0.0]]).T
COEFD = np.array([[7.03047e-1, -2.63501e-3, -1.57023e-6, 0.0],
                  [5.29269e-1, -3.14754e-3, 4.39595e-6, 0.0],
                  [7.88193e-2, 1.31290e-3, 4.25827e-6, -1.23982e-8],
                  [1.62744e-1, 2.22847e-3, 2.60102e-6, -4.30133e-8]]).T
COEFE = np.array([[3.93137e-2, -4.34341e-5, 3.74545e-8],
                  [3.67785e-2, -3.10794e-5, 2.94436e-8],
                  [7.42500e-2, 3.97397e-5, 0.0],
                  [7.52859e-2, 4.18073e-5, 0.0]]).T
COEFF = np.array([[2.20370e-1, 1.39719e-3, -7.32011e-6, -1.40262e-8,
                   2.13638e-10, -2.35955e-13],
                  [3.07431e-1, 8.27225e-4, -1.30067e-5, 3.49847e-8,
                   2.07835e-10, -1.98937e-12]]).T
COEFG = np.array([[9.04489, -9.56499e-3],
                  [1.80898e1, -1.91300e-2],
                  [8.72239, -9.53359e-3],
                  [1.74448e1, -1.90672e-2]]).T
COEFH = np.array([[5.46557e1, -7.30387e-2],
                  [1.09311e2, -1.46077e-1],
                  [5.11479e1, -6.82615e-2],
                  [1.02296e2, -1.36523e-1]]).T
COEFI = np.array([[3.31654e-1, -2.86103e-4, -7.87860e-6, 5.88187e-8,
                   -1.25340e-10, -1.37731e-12],
                  [3.14365e-1, -1.33872e-3, -2.15585e-6, 6.07798e-8,
                   -3.45612e-10, -9.34139e-15]]).T
COEFJ = np.array([[2.82096e-2, 2.47836e-4, 1.16904e-6],
                  [9.27379e-2, 8.04454e-4, 6.88844e-6]]).T
COEFK = np.array([[2.48852e-1, 2.09667e-3, 2.60377e-6],
                  [1.03594, 6.58620e-3, 4.04456e-6]]).T

# narrow-band H2O data for 800-1000 and 1000-1200 cm-1
REALK = np.array([0.18967069430426e-4, 0.70172244841851e-4])
ST = np.array([0.31930234492350e-3, 0.97907319939060e-3])
A1 = np.array([0.28775403075736e-1, 0.23236701470511e-1])
A2 = np.array([-0.57966222388131e-4, -0.95105504388411e-4])
B1 = np.array([0.29927771523756e-1, 0.21737073577293e-1])
B2 = np.array([-0.86322071248593e-4, -0.78543550629536e-4])

# derived radini coefficients (mod_rad_radiation.F90:805-838); 0-based
# band index
C1 = COEFE[2] / COEFE[1]
C2 = COEFB[2] / COEFB[1]
C3 = COEFB[3] / COEFB[2]
C4 = COEFD[2] / COEFD[1]
C5 = COEFD[3] / COEFD[2]
C6 = COEFA[2] / COEFA[1]
C7 = COEFC[2] / COEFC[1]
C8 = COEFF[2, 0] / COEFF[1, 0]
C9 = COEFF[2, 1] / COEFF[1, 1]
C10 = COEFF[3, 0] / COEFF[2, 0]
C11 = COEFF[3, 1] / COEFF[2, 1]
C12 = COEFF[4, 0] / COEFF[3, 0]
C13 = COEFF[4, 1] / COEFF[3, 1]
C14 = COEFF[5, 0] / COEFF[4, 0]
C15 = COEFF[5, 1] / COEFF[4, 1]
C16 = COEFJ[2, 0] / COEFJ[1, 0]
C17 = COEFK[2, 0] / COEFK[1, 0]
C18 = COEFI[2, 0] / COEFI[1, 0]
C19 = COEFI[2, 1] / COEFI[1, 1]
C20 = COEFI[3, 0] / COEFI[2, 0]
C21 = COEFI[3, 1] / COEFI[2, 1]
C22 = COEFI[4, 0] / COEFI[3, 0]
C23 = COEFI[4, 1] / COEFI[3, 1]
C24 = COEFI[5, 0] / COEFI[4, 0]
C25 = COEFI[5, 1] / COEFI[4, 1]
C26 = COEFJ[2, 1] / COEFJ[1, 1]
C27 = COEFK[2, 1] / COEFK[1, 1]
C28 = 0.5
C29 = 0.002053
C30 = 0.1
C31 = 3.0e-5
CFA1 = 0.61

# trace-gas band tables (mod_rad_tracer.F90 data statements; the same
# g1..g4/ab/bb/abp/bbp sets are used by trcab/trcabn/trcems)
TRC_G1 = np.array([0.0468556, 0.0397454, 0.0407664, 0.0304380,
                   0.0540398, 0.0321962])
TRC_G2 = np.array([14.48320, 4.302420, 5.23523, 3.25342, 0.698935,
                   16.55990])
TRC_G3 = np.array([26.18980, 18.44760, 15.36330, 12.19270, 9.14992,
                   8.07092])
TRC_G4 = np.array([0.0261782, 0.0369516, 0.0307266, 0.0243854,
                   0.0182932, 0.0161418])
TRC_AB = np.array([3.0857e-2, 2.3524e-2, 1.7310e-2, 2.6661e-2,
                   2.8074e-2, 2.2915e-2])
TRC_BB = np.array([-1.3512e-4, -6.8320e-5, -3.2609e-5, -1.0228e-5,
                   -9.5743e-5, -1.0304e-4])
TRC_ABP = np.array([2.9129e-2, 2.4101e-2, 1.9821e-2, 2.6904e-2,
                    2.9458e-2, 1.9892e-2])
TRC_BBP = np.array([-1.3139e-4, -5.5688e-5, -4.6380e-5, -8.0362e-5,
                    -1.0115e-4, -8.8061e-5])

# Planck band tables for trace gases (trcplk, mod_rad_tracer.F90)
PLK_F1 = np.array([5.85713e8, 7.94950e8, 1.47009e9, 1.40031e9,
                   1.34853e8, 1.05158e9, 3.35370e8, 3.99601e8,
                   5.35994e8, 8.42955e8, 4.63682e8, 5.18944e8,
                   8.83202e8, 1.03279e9])
PLK_F2 = np.array([2.02493e11, 3.04286e11, 6.90698e11, 6.47333e11,
                   2.85744e10, 4.41862e11, 9.62780e10, 1.21618e11,
                   1.79905e11, 3.29029e11, 1.48294e11, 1.72315e11,
                   3.50140e11, 4.31364e11])
PLK_F3 = np.array([1383.0, 1531.0, 1879.0, 1849.0, 848.0, 1681.0,
                   1148.0, 1217.0, 1343.0, 1561.0, 1279.0, 1328.0,
                   1586.0, 1671.0])

# ozone climatology profiles (mod_rad_o3blk.F90:56-86): annual mean of
# summer/winter standard profiles on 31 pressure levels (hPa)
O3SUM = np.array([5.297e-8, 5.852e-8, 6.579e-8, 7.505e-8, 8.577e-8,
                  9.895e-8, 1.175e-7, 1.399e-7, 1.677e-7, 2.003e-7,
                  2.571e-7, 3.325e-7, 4.438e-7, 6.255e-7, 8.168e-7,
                  1.036e-6, 1.366e-6, 1.855e-6, 2.514e-6, 3.240e-6,
                  4.033e-6, 4.854e-6, 5.517e-6, 6.089e-6, 6.689e-6,
                  1.106e-5, 1.462e-5, 1.321e-5, 9.856e-6, 5.960e-6,
                  5.960e-6])
PPSUM = np.array([955.890, 850.532, 754.599, 667.742, 589.841, 519.421,
                  455.480, 398.085, 347.171, 301.735, 261.310, 225.360,
                  193.419, 165.490, 141.032, 120.125, 102.689, 87.829,
                  75.123, 64.306, 55.086, 47.209, 40.535, 34.795,
                  29.865, 19.122, 9.277, 4.660, 2.421, 1.294, 0.647])
O3WIN = np.array([4.629e-8, 4.686e-8, 5.017e-8, 5.613e-8, 6.871e-8,
                  8.751e-8, 1.138e-7, 1.516e-7, 2.161e-7, 3.264e-7,
                  4.968e-7, 7.338e-7, 1.017e-6, 1.308e-6, 1.625e-6,
                  2.011e-6, 2.516e-6, 3.130e-6, 3.840e-6, 4.703e-6,
                  5.486e-6, 6.289e-6, 6.993e-6, 7.494e-6, 8.197e-6,
                  9.632e-6, 1.113e-5, 1.146e-5, 9.389e-6, 6.135e-6,
                  6.135e-6])
PPWIN = np.array([955.747, 841.783, 740.199, 649.538, 568.404, 495.815,
                  431.069, 373.464, 322.354, 277.190, 237.635, 203.433,
                  174.070, 148.949, 127.408, 108.915, 93.114, 79.551,
                  67.940, 58.072, 49.593, 42.318, 36.138, 30.907,
                  26.362, 16.423, 7.583, 3.620, 1.807, 0.938, 0.469])


def o3_annual_profile():
    """Annual-mean ozone vmr profile on PPSUM levels
    (o3data, mod_rad_o3blk.F90:108-138)."""
    o3ann = np.empty(31)
    o3ann[0] = 0.5 * (O3SUM[0] + O3WIN[0])
    o3ann[1:] = O3WIN[:-1] + (O3WIN[1:] - O3WIN[:-1]) \
        / (PPWIN[1:] - PPWIN[:-1]) * (PPSUM[1:] - PPWIN[:-1])
    o3ann[1:] = 0.5 * (o3ann[1:] + O3SUM[1:])
    return o3ann, PPSUM * 100.0        # vmr, Pa


def ghg_mmr(scenario_gases):
    """vmr/ppb concentrations → mass mixing ratios (radini,
    mod_rad_radiation.F90:769-800). scenario_gases: dict with co2 (ppm),
    ch4 (ppb), n2o (ppb), cfc11 (ppt), cfc12 (ppt)."""
    co2vmr = scenario_gases["co2"] * 1.0e-6
    return dict(
        co2vmr=co2vmr,
        co2mmr=co2vmr * (AMCO2 / AMD),
        ch40=scenario_gases["ch4"] * 1.0e-9 * (AMCH4 / AMD),
        n2o0=scenario_gases["n2o"] * 1.0e-9 * (AMN2O / AMD),
        cfc110=scenario_gases.get("cfc11", 0.0) * 1.0e-12
        * (AMCFC11 / AMD),
        cfc120=scenario_gases.get("cfc12", 0.0) * 1.0e-12
        * (AMCFC12 / AMD))
