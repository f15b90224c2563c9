"""Physical constants for the TPU regional climate framework.

Values mirror the reference model's constants module
(``Share/mod_constants.F90:27-212`` in RegCM4) so prognostic fields can be
compared *allclose* against the Fortran reference. All constants are plain
Python floats — they enter jitted code as compile-time literals.
"""

# Numeric guards ---------------------------------------------------------
minqq = 1.0e-8        # minimum specific humidity
minqc = 1.0e-10       # minimum cloud condensate
minqv = minqq * 100.0
minqx = 1.0e-16
mintr = 1.0e-20       # minimum tracer mixing ratio
dlowval = 1.0e-20
dhival = 1.0e+20
dmissval = 1.0e+20

# Time -------------------------------------------------------------------
secpm = 60.0
secph = 3600.0
secpd = 86400.0
houpd = 24.0

# Gravity / fundamental --------------------------------------------------
egrav = 9.80665               # standard gravity (m s-2)
sigm = 5.670400e-8            # Stefan-Boltzmann (W m-2 K-4)
boltzk = 1.3806504e-23        # Boltzmann (J K-1)
navgdr = 6.02214129e23        # Avogadro (mol-1)

# Molecular weights (g mol-1) -------------------------------------------
amd = 28.96454                # dry air
amw = 18.01528                # water
amo2 = 31.9988
amo3 = 47.99820
amco2 = 44.00950
amn2o = 44.0128
amch4 = 16.04246
amcfc11 = 137.368103
amcfc12 = 120.913506

# Gas constants ----------------------------------------------------------
rgasmol = navgdr * boltzk            # universal gas constant ~8.3144718
c287 = rgasmol / amd                 # 0.2870569 (kJ kg-1 K-1)
rgas = c287 * 1000.0                 # dry air gas constant ~287.0569
rdry = rgas
rwat = (rgasmol / amw) * 1000.0      # water vapour gas constant ~461.5233
rgow = rgas / rwat                   # epsilon ~0.62198
rgowi = rwat / rgas
ep1 = rgowi - 1.0                    # (Rv/Rd - 1) ~0.60776 for virtual T
ep2 = rgow                           # Rd/Rv

# Specific heats ---------------------------------------------------------
cpd = 3.5 * rgas                     # dry air cp ~1004.699
cvd = 2.5 * rgas                     # dry air cv ~717.642
cpv = 4.0 * rwat                     # water vapour cp ~1846.093
cpw = 4186.95                        # liquid water
cpi = 2106.0                         # ice
cpw0 = 4218.0

# Latent heats (J kg-1) --------------------------------------------------
wlhv = 2.50080e6                     # vaporisation
wlhf = 0.33355e6                     # fusion
wlhs = wlhv + wlhf                   # sublimation
rwlhv = 1.0 / wlhv
rwlhf = 1.0 / wlhf
rwlhs = 1.0 / wlhs

# Derived ----------------------------------------------------------------
regrav = 1.0 / egrav
rcpd = 1.0 / cpd
rovcp = rgas * rcpd                  # R/cp ~0.28571
rdrcv = rgas / cvd
cpovr = cpd / rgas
rovg = rgas / egrav
govr = egrav / rgas
gdry = -egrav / cpd                  # dry adiabatic lapse rate
hcratio = cpv * rcpd
hcrm1 = hcratio - 1.0

# Densities / reference temperatures ------------------------------------
rhoh2o = 1000.0
rhosea = 1026.0
rhosnow = 100.0
rhoice = 917.0
tzero = 273.15
tiso = 216.65                        # isothermal stratosphere temperature
rtzero = 1.0 / tzero
wattp = 273.16                       # water triple point
tboil = 373.1339

# Saturation vapour pressure (Tetens/Teten-Magnus, reference c1es..c5ies)
c1es = 610.78
c2es = c1es * amw / amd
c3les = 17.2693882                   # over liquid
c3ies = 21.875                       # over ice
c4les = 35.86
c4ies = 7.66
c5les = c3les * (tzero - c4les)
c5ies = c3ies * (tzero - c4ies)
c5alvcp = c5les * wlhv * rcpd
c5alscp = c5ies * wlhs * rcpd
wlhvocp = wlhv * rcpd
wlhfocp = wlhf * rcpd
cpowlhv = cpd / wlhv                 # cp/Lv (Share/mod_constants)
wlhsocp = wlhs * rcpd

# Earth / orbit ----------------------------------------------------------
earthrad = 6.371229e6                # earth radius (m)
erkm = earthrad / 1000.0
rearthrad = 1.0 / earthrad
eomeg = 7.2921159e-5                 # earth angular velocity (rad s-1)
solcon = 1367.0                      # solar constant (W m-2)
scon = solcon

# Von Karman / surface layer --------------------------------------------
vonkar = 0.4

# Kain-Fritsch / WSM5 / Betts-Miller saturation constants
# (Share/mod_constants.F90:327-338)
aliq = 613.3
bliq = 17.502
cliq = 4780.8
dliq = 32.19
aice = 613.20
bice = 22.452
cice = 6133.0
dice = 0.61
xlv0 = 3.15e6
xlv1 = 2370.0
xls0 = 2.905e6
xls1 = 259.532
pq0 = 379.90516          # (:223)
stdp = 1.013250e5                    # standard surface pressure (Pa)
stdpmb = 1013.250
stdt = 288.15
lrate = 0.00649                      # standard atmosphere lapse rate K/m

import math as _math

mathpi = _math.pi
twopi = 2.0 * _math.pi
halfpi = 0.5 * _math.pi
degrad = _math.pi / 180.0            # degrees → radians
raddeg = 180.0 / _math.pi

# standard air density (Share/mod_constants.F90:234)
stdrho = 1.28
