#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

On a host with four or more cards, phase 10 runs the nccl path too.

Phases (any failure raises and the script exits nonzero):
  1. card, power limit and library versions;
  2. build the five hand-written CUDA kernels from regcm_tpu_torch/csrc,
     one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, f64 and
     f32, at a small ragged shape and at the MOLOCH 192x192x41 shape
     (and at EDGE_SHAPES), with the kernel and plain times through the
     wrapper (CUDA events) and the kernel's own device time
     (torch.profiler) beside each kernel's bound at the MOLOCH shape
     (and at the test_001 shape for K1, K2);
  4. the hydrostatic path: Model(RegCMConfig()) at test_001 size
     (34x48x18, dt 150 s, f32) for 24 steps through K1 and K2 (launch
     counters checked), then the ms/step of 24 further steps;
  5. the same Model for 10 steps in f64 on the card and on the CPU;
  6. the MOLOCH path: Model with idynamic=3 at 192x192x41 (ds 3 km,
     dt 30 s, f32) for 24 steps through K1, K2, K3 and K4 (launch
     counters checked), then the ms/step of 24 further steps without
     radiation, a torch.profiler view of 4 more and the time of the
     radiation step 60; then the same settings on a 48x48x41 domain for
     24 steps, held to the JAX package's numbers;
  7. MOLOCH on the card against the CPU in f64 at 16x20x14 over a hill;
  8. (the kernels line, printed at the end);
  9. the decomposed kernels K5a/b/c in one process: the 192x192x41 K4
     inputs (f32, f64) and the K3, K1 inputs cut into 2x2 blocks, each
     block halo-extended from the global tensors as the CPU tests do,
     each block's result assembled and held to the unsharded kernel bit
     for bit and to the plain version, the per-block time beside its
     bound; then K5a on an uneven 3x2 cut of the small K4 shape, held to
     K4 bit for bit;
 10. the decomposed MOLOCH flagship: 2x2 ranks at 192x192x41 f32 (gloo
     with host-staged halos on the card(s); with four or more cards
     also nccl, one card a rank), 12 steps held bit for bit to phase
     6's single-card run, the ms/step of steps 15-20 (the cumulus and
     surface step among them), halo exchanges and bytes a step and each
     rank's K1-K5 launches;
 11. decomposed MOLOCH in f64 at 32x32x14 over phase 7's hill, the
     three-step setting of dryrun_multichip, 2x2 against one card;
 12. the decomposed hydrostatic core in the same groups: (a) f64 at
     dryrun_multichip's 16x16x14 settings (dynamics, and full physics
     with every alarm at step 0), 2x2 against one card; (b) test_001
     (34x48x18, f32) from phase 13's ICBC files for 24 steps (two
     radiation cycles), held at steps 12 and 24 to phase 13's
     single-card run bit for bit or, where it is not, by the f32 rule
     (four times the single card's rel-RMS spread under a 1e-7 change
     of T); then phase 13a's SAV after step 138 loaded on 2x2 ranks and
     run past the 6-hourly boundary update after step 144 to step 150,
     bit for bit 13a's step 150 with its boundary clock; the ms/step,
     halo exchanges and bytes a step and each rank's K5c and K2
     launches;
 13. ICBC-driven runs on one card (run before phase 12, which is held to
     13a): (a) test_001 from a DOMAIN file of a 500 m hill and a
     one-day ICBC file (10 m/s jet) written by the port's preprocessors,
     init_from_icbc and run_icbc through step 150, with the ms/step of
     the steps without radiation and of the radiation steps; (b) the
     MOLOCH flagship (192x192x41, flat, 10 m/s jet) from a one-day ICBC
     file through step 61 (radiation at 60): that it stayed finite,
     ms/step over steps 24-47, the radiation step and the peak device
     memory;
 14. the MM5 non-hydrostatic core (idynamic=2), after phase 13 and, for
     14c, in the decomposed group of phases 10-12: (a) Model at the
     flagship's widths (192x192x41, ds 3 km, f32, flat, default
     physics) with dt 15 s, half the flagship's (NH_DT says why), from
     nh_initial_state(perturb=0.5, seed=1): 24 steps through K1 and K2
     (launch counters checked), the ms/step of steps 24-47, a
     torch.profiler view of 4 steps, the radiation step (step 120 at
     dt 15 s), the peak device memory, and the first non-finite step or
     that the run stayed finite past the radiation step; then the same
     settings on a 48x48x41 cut for 24 steps, held to the JAX package's
     numbers (NH_REFERENCE); (b) NH on the card against the CPU in f64
     at 16x20x14 over phase 7's hill for 10 steps, full physics and
     dynamics only, held as phase 5; (c) the 14a flagship on 2x2 ranks,
     12 steps held bit for bit to 14a's step 12, the ms/step, halo
     exchanges and bytes a step and each rank's K5c and K2 launches; (d)
     each ported dynamics option (idiffu 2/3, iboudy 1/3/4, ipgf 1,
     ithadv 1, isladvec with iqmsl 0/1; on the NH core idiffu 3 and
     iboudy 4) on the card against the CPU in f64, 3 steps at 18x24x14;
 15. the second physics set, after phase 14 and, for 15e, in the
     decomposed group: (a) configuration A (Emanuel over land, Tiedtke
     over water, the UW TCM, Nogherotto-Tompkins) on test_001 from phase
     13's ICBC files (f32) for 13 steps, with the ms/step of plain,
     cumulus and radiation steps, K2's launches and the device kernels of
     a cumulus step; (b) configuration B (no deep convection,
     Nogherotto-Tompkins, Holtslag) on MOLOCH at 192x192x41 (f32): 24
     steps through K1, K3 and K4 at nf = 10 (counters checked), the
     ms/step of steps 24-47, the peak memory and the first non-finite
     step, then a 48x48x41 cut for 12 steps held to the JAX package's
     numbers (B_REFERENCE); (c) each new scheme and each icldfrac on the
     card against the CPU in f64 at 16x20x14; (d) K4 and K5a (2x2
     blocks) at nf = 10 against their plain versions and K5a against K4
     bit for bit, with device time and bound; (e) A on 2x2 ranks (gloo)
     held to (a) bit for bit at step 12;
 16. the remaining cumulus schemes, after phase 15 and, for 16d, in the
     decomposed group: (a) configuration C, RegCM4's CORDEX setting
     (Grell over land, Emanuel over water, Holtslag, SUBEX) at the
     EUR-44 extent (106x103x18, ds 50 km, dt 150 s, f32) from DOMAIN and
     ICBC files the port's preprocessors write, through step 150 past
     the boundary update after step 144: the ms/step of plain, cumulus,
     surface and radiation steps, K1 and K2 launches, a cumulus step's
     device kernels and busy share, the peak memory, the land fraction;
     (b) Kuo, Betts-Miller with shallow convection and Kain-Fritsch on
     test_001 from phase 13's ICBC files for 13 steps: the ms/step of
     each alarm class and a cumulus step's device kernels; (c)
     each new scheme and C on the card against the CPU in f64 at
     16x20x14, 3 steps, with the saturation adjustment on and off (as
     phase 5); (d) C on 2x2 ranks (gloo) on test_001 from phase
     13's files, held bit for bit to one card at step 12, with K5c's
     launches;
 17. the rest of the physics matrix, after phase 16 and, for 17b, in the
     decomposed group: (a) configuration D, RegCM4's tropical band
     (i_band=1, Mercator about the equator, 140x802x18 at ds 50 km so
     that jx·ds closes the equator's circle, dt 150 s, f32; Emanuel,
     Holtslag, SUBEX, CCM3, BATS1e, COARE ocean fluxes and the slab
     ocean) from DOMAIN and ICBC files the port's preprocessors write,
     24 steps (two radiation cycles): the ms/step of plain, cumulus,
     surface and radiation steps, K1 and K2 launches, a cumulus step's
     device kernels and busy share, the peak memory and the slab SST's
     change, then K1 and K2 held against their plain versions on the
     operands of one of D's cumulus steps; (b) D on 2x2 ranks (gloo)
     held bit for bit to one card at step 12, with K5c's launches and
     the exchanges and bytes a step of each rank, and the doubly
     periodic CRM (16x16x14, ds 4 km, f64; the CPU tests' run) 2x2
     against one card at 1e-12; (c) GFS, MYJ, WSM5, Zeng with the
     skin SST, sea ice and the lake (a 20 m lake, a 270 K sea) and the
     BATS ocean fluxes with nsg=2, each on test_001 from phase 13's
     files for 13 steps: the ms/step of each alarm class and a surface
     step's device kernels; (d) the three Model settings of the CPU
     tests on the card against the CPU in f64 at 16x20x14, 3 steps, as
     16c;
 18. restart, output and the decomposed semi-Lagrangian advection, f32:
     (a) restart chains at full width riding on earlier runs, each SAV
     loaded into a fresh Model and run on, every state and boundary
     field held bit for bit to the uninterrupted run: test_001 from
     phase 13's files saved at step 138 and run to 150, past the update
     after step 144 (13a; 12b loads the same SAV on 2x2 ranks); the MOLOCH flagship from its ICBC start, 12
     + 12 steps (13b); the NH flagship at dt 15 s, 12 + 12 steps (14a);
     the SAV's size and its write and read seconds; (b) in the
     decomposed group, test_001 with isladvec=1 on 2x2 ranks: a SAV at
     step 6 and a fresh Model to step 12, bit for bit to the
     uninterrupted 2x2 run, which is bit for bit one card's; (c)
     run_with_output at the MOLOCH flagship from 13b's SAV over 24
     steps, ATM, SRF and RAD every 6, on NetCDF and on Zarr: the ms of
     plain and output steps and of each writer, the writer thread's
     encoding and the bytes, the Zarr stores equal to the NetCDF files
     and the last ATM record equal to Model.decoupled() cut and rotated;
     (d) in the decomposed group, the same test_001 with iqmsl 0 and 1
     bit for bit one card's at step 6;
 19. the aerosol chemistry and its tracer transport, after phase 18 and,
     for 19e, in the decomposed group: (a) configuration E = D plus AERO
     (RegT-Band with chemistry, BASELINE.json's fifth configuration)
     from phase 17's files, the land desert, the start moistened (qv
     1.9 times the files', so that Emanuel convects), the carbon and
     sulfur tracers seeded, 24 steps: launches (K1 twice a step, Holtslag's
     fields and the tracers at ns = ntr; K2 in its tracer form on the
     cumulus steps), the ms/step of each alarm class, a chemistry step's
     device kernels and busy share, the peak memory, each tracer group's
     burden, emission and deposition (dust and sea salt must emit,
     convective rain fall and dust wash out), then K1 at ns = ntr and
     K2's tracer form against their plain versions on the operands of
     one of E's cumulus steps (some column convecting), f32 1e-5 and f64
     1e-12,
     with device time and bound; (b) the test_008 setting (DUST,
     idirect=2) on test_001 from phase 13's files at noon, 12 steps,
     with a dust layer: the surface SW against idirect=0; (c) the MOLOCH
     flagship with DUST from phase 13's ICBC file, 12 steps through K1-K4
     with the tracers in K4's stack (nf = 11), the ms/step; (d) the CPU
     tests' chemistry settings (the nine chemsimtypes, DUST on MOLOCH,
     Grell's columns under cumtran) on the card against the CPU in f64
     at 16x20x14, 3 steps, held as 16c; (e) E's settings on test_001's
     widths on 2x2 ranks, bit for bit one card's at step 12, with K5c's
     launches and the exchanges a step; (f) run_with_output on (b) with
     CHE and OPT every 6 steps on NetCDF and on Zarr, equal record for
     record;
 20. the gas-phase chemistry, after phase 19 and, for 20d, in the
     decomposed group: (a) configuration F = E plus the gas phase (DCCB:
     CBMZ, the aerosols and the SNA equilibrium, 50 tracers) from phase
     17's files and a CHBC file of the port's chem_icbc, the tracers
     from its record, NH3, H2SO4 and HNO3 seeded, the rest of the state
     after 4 steps of E's start without chemistry, 2 steps: launches (K1
     twice a step at ns = 5 and 50, K2's tracer form at ntr = 50, K6's
     factorisation and solve each Ros2 iteration), the ms of each step
     class, the gas solver's ms, Ros2 iterations and host syncs a call,
     the peak memory; ozone moves, ammonium and nitrate aerosol form, the
     northern ring holds the CHBC records; then K1, K2's tracer form and
     K6 against their plain versions on F's own operands, recorded in
     that run (f32 1e-5, f64 1e-12), with device time and bound; (b) on
     test_001 from phase 13's files, 4 steps each: AERO under Tiedtke
     over both surfaces with lmfsmooth (ctracer on the cumulus steps),
     CBMZ and CB6 with their CHBC files; (c) the CPU tests' gas-phase
     settings on the card against the CPU in f64, 3 steps; (d) CBMZ on
     test_001's widths on 2x2 ranks, bit for bit one card's at step 6,
     with K5c's and K6's launches and the exchanges a step;
then a JSON line of the kernels and the result line. The CPU side of
every card-vs-CPU phase (5, 7, 14b, 14d, 15c, 16c, 17d, 19d, 20c) runs
in one pool of CPU_WORKERS spawned processes, one torch thread each,
submitted at the start and ended before the decomposed group; each
phase reads its CPU runs after its card runs.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

STEPS = 24
CHECK_STEPS = 10
RAD_STEP = 60          # the first radiation alarm after step 0
# the JAX package (float32, CPU) at MOLOCH 3 km settings on a 48x48x41
# domain from the 0.3 K perturbed rest state: step -> (ps min hPa, ps max
# hPa, max |w| m/s); the same numbers as tests/test_torch_moloch_3km.py
REFERENCE = {6: (1011.3323, 1013.6910, 0.22048),
             12: (1010.3247, 1014.5790, 0.20938),
             18: (1002.8120, 1022.8336, 0.65207),
             24: (979.3270, 1055.1946, 3.13658)}
# kernel vs plain tolerances, relative to the scale of each output:
# f64 recurrences and sums agree to roundoff; f32 sums reordered
TOL = {"float64": {"K1": 1e-12, "K2": 1e-10, "K3": 1e-12, "K4": 1e-12},
       "float32": {"K1": 1e-5, "K2": 1e-5, "K3": 1e-5, "K4": 1e-5}}
for _d in TOL.values():         # the decomposed forms: K1, K3, K4's sums
    _d.update(K5a=_d["K4"], K5b=_d["K3"], K5c=_d["K1"])
# published H100 SXM peaks: HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
NAMES = {"K1": "pbl_tridiag", "K2": "emanuel_mixing", "K3": "tridiag_w",
         "K4": "waf_advect", "K5a": "waf_advect_sharded",
         "K5b": "tridiag_w_sharded", "K5c": "pbl_tridiag_sharded"}
REPLACES = {"K1": "regcm_tpu/dynamics/pallas_kernels.py:520",
            "K2": "regcm_tpu/dynamics/pallas_kernels.py:426",
            "K3": "regcm_tpu/dynamics/pallas_kernels.py:68",
            "K4": "regcm_tpu/dynamics/pallas_kernels.py:321",
            "K5a": "regcm_tpu/dynamics/pallas_kernels.py:350",
            "K5b": "regcm_tpu/dynamics/pallas_kernels.py:409",
            "K5c": "regcm_tpu/dynamics/pallas_kernels.py:553"}
# the decomposed kernels: the unsharded kernel each is held to, and the
# CUDA source of both
BASE = {"K5a": "K4", "K5b": "K3", "K5c": "K1"}
SOURCE = {k: NAMES[BASE.get(k, k)] for k in NAMES}
FLAGSHIP = 192                  # the MOLOCH 3 km domain, iy = jx
GRID = (2, 2)                   # the decomposed runs' grid of ranks
DECOMP_STEPS = 12
# the decomposed flagships' timing window: steps TIME_START.. of
# TIME_STEPS steps, which holds the cumulus and surface step (20)
TIME_START = 15
TIME_STEPS = 6
# shapes: (small ragged or test_001 shape, MOLOCH 192x192x41 shape)
SHAPES = {"K1": [(5, 18, 34, 48), (5, 41, 192, 192)],
          "K2": [(34 * 48, 18), (192 * 192, 41)],
          "K3": [(13, 34, 48), (40, 192, 192)],
          "K4": [(7, 14, 34, 48), (7, 41, 192, 192)]}
# shapes that stress the redesigned kernels' layouts, checked and not
# timed: K2 where its lanes take one level (L = 32) or two (33, 64); K4
# on strips and rows cut by the domain's edge (iy, jx not multiples of
# its 28-column strips and 8-row marches) with one field of two levels;
# K1 and K3 on an odd plane (rows of 37x45 values break 16-byte
# alignment, the last block of 32 columns is ragged), on one-level
# columns and on columns of 100 levels (K3: 99 interfaces)
EDGE_SHAPES = {"K1": [(5, 41, 37, 45), (2, 1, 5, 7), (1, 100, 16, 20)],
               "K2": [(500, 32), (500, 33), (500, 64)],
               "K3": [(40, 37, 45), (1, 5, 7), (99, 16, 20)],
               "K4": [(1, 2, 37, 45)]}
# the kernels rewritten after their first port -> the change that did it
REDESIGNED = {"K1": 5, "K2": 4, "K3": 5, "K4": 4, "K5a": 4, "K5b": 5,
              "K5c": 5}
# the device kernels each wrapper launches (K5: those of its base)
KERNELS = {"K1": ("pbl_tridiag_kernel",), "K2": ("emanuel_mixing_kernel",),
           "K3": ("tridiag_w_kernel",),
           "K4": ("waf_vertical", "waf_horizontal")}
# phase 9's uneven cut of the small K4 shape: block row and column edges
UNEVEN = ((7, 14, 34, 48), (0, 11, 23, 34), (0, 20, 48))
# phases 12, 13: the ICBC files cover one day (five 6-hourly records);
# test_001 runs past the update after step 144 and is compared at
# HYDRO_CHECK; the MOLOCH flagship runs through the radiation step 60
ICBC_END = 1990060200
HYDRO_ICBC_STEPS = 150
# 12b's steps on 2x2 ranks from the ICBC start (four radiation cycles);
# its run past the update starts from 13a's SAV after step 138 (18a's)
HYDRO_CHECK = (12, 24)
MOLOCH_ICBC_STEPS = RAD_STEP + 1
HYDRO_FIELDS = ("ps", "t", "qv", "u", "v")
# phase 14: the NH flagship's dt. At 30 s the acoustic solver's substeps
# of a leapfrog step (istep = max(int(2·dtsec/dtsmax), 4) = 7 of 8.57 s)
# exceed dtsmax = dx/cs/(1+nhxkd) = 7.86 s at 3 km, and the JAX
# package's run goes non-finite within 12 steps; at 15 s, 4 of 7.5 s
# (tools/nh_3km_reference.py)
NH_DT = 15.0
# the JAX package (float32, CPU) at the NH flagship's settings on a
# 48x48x41 cut from nh_initial_state(perturb=0.5, seed=1): step -> (max
# |w| m/s, max |pp| Pa, T min K, T max K), printed by
# tools/nh_3km_reference.py (finite through step 48)
NH_REFERENCE = {6: (2.02362, 117.1183, 215.1272, 289.1259),
                12: (1.99391, 161.7405, 215.1756, 289.0446),
                18: (1.56147, 177.3113, 215.1847, 288.9917),
                24: (1.50451, 180.5096, 215.2156, 288.9692)}
NH_FIELDS = ("t", "qv", "u", "v", "pp", "w")
# 14d: option -> (core: 1 hydrostatic, 2 NH; physicsparam overrides, or
# the dynparam extra "ithadv")
OPTIONS = {"idiffu2": (1, dict(idiffu=2)), "idiffu3": (1, dict(idiffu=3)),
           "iboudy1": (1, dict(iboudy=1)), "iboudy3": (1, dict(iboudy=3)),
           "iboudy4": (1, dict(iboudy=4)), "ipgf1": (1, dict(ipgf=1)),
           "ithadv1": (1, dict(ithadv=1)),
           "isladvec_qmsl0": (1, dict(isladvec=1, iqmsl=0)),
           "isladvec_qmsl1": (1, dict(isladvec=1, iqmsl=1)),
           "nh_idiffu3": (2, dict(idiffu=3)),
           "nh_iboudy4": (2, dict(iboudy=4))}


# phase 15: configuration A (Emanuel over land, Tiedtke over water, the
# UW TCM, Nogherotto-Tompkins) and B (no deep convection,
# Nogherotto-Tompkins, Holtslag)
SCHEME_A = dict(icup_lnd=4, icup_ocn=5, ibltyp=2, ipptls=2, icldfrac=0)
SCHEME_B = dict(icup_lnd=0, icup_ocn=0, ibltyp=1, ipptls=2, icldfrac=0)
B_STEPS = 24
# 15a's depth: two radiation cycles (phases 13a and 12b run test_001
# past the boundary update after step 144)
A_STEPS = 13         # steps 1..12 hold a radiation step (12)
NF10 = 10          # B's WAF stack: θv, π, ux, vx, wx and five species
# the JAX package (float32, CPU) with B's physics on a 48x48x41 MOLOCH
# cut from initial_state(perturb=0.3, seed=1) moistened as moisten()
# does it: step -> (ps min hPa, ps
# max hPa, max |w| m/s, max qc, qr, qi, qs kg/kg), printed by
# tools/moloch_3km_schemes_reference.py
B_REFERENCE = {6: (1011.5966, 1014.1085, 0.33896, 1.000000e-04, 0.0,
                   3.463735e-05, 8.895323e-10),
               12: (1010.7578, 1014.9992, 0.43865, 1.000000e-04, 0.0,
                    4.049361e-05, 1.046149e-09)}


# phase 16: configuration C, RegCM4's CORDEX setting (Grell over land,
# FC80 closure; MIT-Emanuel over water; Holtslag; SUBEX) at the EURO-CORDEX
# EUR-44 extent (106 x 103 points, 0.44 deg ~ 50 km, RegCM4's 18 levels),
# centred at RegCMConfig's 45N 13E; the other new schemes on test_001
SCHEME_C = dict(icup_lnd=2, icup_ocn=4, igcc=2, ibltyp=1, ipptls=1,
                icldfrac=0)
EUR44 = (103, 106, 18)              # iy, jx, kz
CU_SCHEMES = {"Kuo": dict(icup_lnd=1, icup_ocn=1),
              "Betts-Miller + shallow": dict(icup_lnd=3, icup_ocn=-3),
              "Kain-Fritsch": dict(icup_lnd=6, icup_ocn=6)}
CU_STEPS = 13        # steps 1..12 hold a radiation step (12)
# 16c: (name, idynamic, ds, dt, physics overrides); the start's qv is 1.9
# times the rest state's (95% of saturation): at 1.8 the ocean points sit
# on SUBEX's rh0 = 0.9, where its cloud fraction is a roundoff
CU_CASES = (("C", 1, 50.0, 150.0, SCHEME_C),
            ("Kuo", 1, 50.0, 150.0, dict(SCHEME_C, icup_lnd=1, icup_ocn=1)),
            ("Betts-Miller + shallow", 1, 50.0, 150.0,
             dict(SCHEME_C, icup_lnd=3, icup_ocn=-3)),
            ("Kain-Fritsch, UW TCM, nogtom", 1, 50.0, 150.0,
             dict(icup_lnd=6, icup_ocn=6, ibltyp=2, ipptls=2, icldfrac=0)),
            ("Grell on MOLOCH", 3, 3.0, 30.0,
             dict(SCHEME_C, icup_ocn=2)))
CU_QVFAC = 1.9


# phase 17: configuration D, RegCM4's tropical band (i_band=1, the
# reference's Testing/test_009.in and test_010.in; RegT-Band, Coppola et
# al. 2012) less its chemistry: x-periodic Mercator about the equator,
# Emanuel, Holtslag, SUBEX, CCM3, BATS1e, COARE over the ocean and the
# slab ocean restoring toward the SST. jx·ds closes the equator's circle
# (802 x 50 km = 40,100 km); iy covers about ±31° of latitude
SCHEME_D = dict(icup_lnd=4, icup_ocn=4, ibltyp=1, ipptls=1, icldfrac=0,
                iocnflx=3, islab_ocean=1)
BAND = (140, 802, 18)               # iy, jx, kz
D_STEPS = 24                        # two radiation cycles
D_CHECK = 12                        # 17b's step
# 17c: each other new setting on test_001 from phase 13's files: the
# physicsparam overrides, and nsg or a lake and a cold sea
NEW_SETTINGS = {"GFS": dict(physics=dict(ibltyp=3)),
                "MYJ": dict(physics=dict(ibltyp=4)),
                "WSM5": dict(physics=dict(ipptls=3)),
                "Zeng + dcsst + sea ice + lake": dict(
                    physics=dict(idcsst=1, iseaice=1, lakemod=1),
                    lake=True),
                "BATS ocean fluxes, nsg=2": dict(
                    physics=dict(iocnflx=1), nsg=2)}
# 17d: the three Model settings of the CPU tests (tests/
# _torch_surface_settings.py) at 16x20x14: (name, idynamic, ds, dt,
# physics, geo, nsg, lake and cold sea)
NEW_CASES = (
    ("(i) band, COARE, slab", 1, 50.0, 150.0, SCHEME_D,
     dict(i_band=1, iproj="NORMER", clat=0.0), 1, False),
    ("(ii) MOLOCH, Zeng, dcsst, sea ice, lake, WSM5, GFS", 3, 3.0, 30.0,
     dict(icup_lnd=0, icup_ocn=0, ibltyp=3, ipptls=3, iocnflx=2, idcsst=1,
          iseaice=1, lakemod=1, icldfrac=0), {}, 1, True),
    ("(iii) NH, MYJ, BATS ocean fluxes, nsg=2", 2, 10.0, 30.0,
     dict(icup_lnd=4, icup_ocn=4, ibltyp=4, ipptls=1, iocnflx=1,
          icldfrac=0), {}, 2, False))
# 17a: the timing repetitions of K1 and K2 on D's operands
D_REPS = 10
# phase 18a: each restart chain's SAV step and end, riding on an earlier
# phase's run (13a, 13b, 14a); 12b runs test_001's SAV on 2x2 ranks too
CHAIN_STEPS = {"test_001": (138, HYDRO_ICBC_STEPS),
               "MOLOCH": (DECOMP_STEPS, STEPS), "NH": (DECOMP_STEPS, STEPS)}
# 18c: run_with_output over 24 MOLOCH steps, a record every 6 (3 min at
# dt 30 s) on ATM, SRF and RAD: four besides the first
OUTPUT_STEPS = 24
OUTPUT_EVERY = 6
# 18b, 18d: test_001 from phase 13's files with the semi-Lagrangian
# advection on 2x2 ranks: iqmsl 0 and 1 to step 6; with iqmsl 1 a SAV
# at 6 and the chain to 12
SL_STEPS = (6, 12)
# phase 19: configuration E = D plus AERO (RegT-Band with chemistry,
# BASELINE.json's fifth configuration; RegCM4 Testing/test_009.in and
# test_010.in) for E_STEPS steps, 19e on 2x2 ranks to E_CHECK; the AERO
# tracers seeded (carbon and sulfur: no emission inventory here) and the
# groups whose burdens are printed; 19b and 19f's test_008 setting at
# noon on test_001 (the sun up), CHEM_STEPS steps, CHE and OPT every
# CHEM_EVERY; 19c's MOLOCH steps; 19d's size
E_STEPS = 24
E_CHECK = 12
E_QVFAC = CU_QVFAC                  # E's start moistened, so that it convects
E_SEEDED = list(range(6))           # BC_HL, BC_HB, OC_HL, OC_HB, SO2, SO4
E_GROUPS = ("BC", "OC", "SO2", "SO4", "DUST", "SSLT")
CHEM_NOON = 1990060112
CHEM_STEPS = 24
CHEM_EVERY = 6
CHEM_CPU_SHAPE = (16, 20, 14)
CHEM_WIND = 10.0                    # m/s westerly added to the ICBC start
# phase 20: configuration F = E plus the gas phase (DCCB: CBMZ, the
# aerosols and the SNA equilibrium; BASELINE.json's fifth configuration in
# full, RegCM4's DCCB chemsimtype, mod_che_common.F90:341-380) for F_STEPS
# steps (the radiation and cumulus step 0 and a plain step: the gas
# solver takes ~15 s a step at 2,021,040 cells) from the state of F_SPINUP
# steps of E's start without the chemistry (from the moistened cold start
# Emanuel's columns convect first at its third call, step 4), its tracers
# from a CHBC file of F_CHBC_HOURS (two records) with F_SEEDED added; K6
# recorded at its F_K6_CALL-th call; 20b's settings GAS_STEPS steps each,
# 20d's 2x2 run GAS_CHECK steps
F_SIM = "DCCB"
F_STEPS = 2
F_SPINUP = 4
F_CHBC_HOURS = 6
# kg/kg at the surface (no emission inventory here): the SNA's ammonia,
# sulfate and nitric acid
F_SEEDED = {"NH3": 2.0e-9, "H2SO4": 1.0e-9, "HNO3": 1.0e-9}
F_K6_CALL = 20
GAS_STEPS = 4
GAS_CHECK = 6
GAS_TIEDTKE = dict(icup_lnd=5, icup_ocn=5)
# 20c's size of the CPU tests' gas-phase settings (the tests run them at
# 8x10x14; at that size a gas tracer's dry-deposition total differed
# between card and CPU at 1.1 times its spread bound)
GAS_CPU_SHAPE = (10, 12, 14)


def gas_settings():
    """The CPU tests' settings module with the gas-phase settings at
    GAS_CPU_SHAPE."""
    from tests import _torch_chem_settings as S
    for name in S.GAS:
        if S.SETTINGS[name].get("shape") == S.GAS_SHAPE:
            S.SETTINGS[name]["shape"] = GAS_CPU_SHAPE
    return S


_T0 = [time.time()]


def stamp(what):
    """Print the script's clock at the start of phase ``what``."""
    print(f"[{time.time() - _T0[0]:.1f} s] {what}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(got, want):
    scale = max(float(want.abs().max()), 1e-300)
    return float((got - want).abs().max()) / scale, \
        float((got - want).abs().max())


# device_ms's calls whose kernels no profiler trace showed, timed with
# CUDA events instead (printed before the kernels line)
EVENT_TIMED = []


def time_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_events(prof):
    """(name, ms) of each device activity in a torch.profiler trace, from
    its raw kineto events: prof.events() builds a Python object for every
    host op as well, ~20 s for the trace of one 15a cumulus step."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def device_ms(fn, kernels, reps=20, tries=5):
    """The device time of one call's kernels: for each name in
    ``kernels``, the mean duration of torch.profiler's CUDA kernel
    events of that name over ``reps`` calls after a warm-up, summed over
    the names (no host time in it). A trace that holds no event of a
    name is taken again, up to ``tries`` traces (the card's tracer now
    and then returns a trace without the kernel events of a run whose
    results were checked just before). If every trace misses a name, the
    call is timed with CUDA events instead (``time_ms``: the whole call,
    its host launch and any copies included, so an upper bound on the
    kernels' time) and the fallback is recorded in EVENT_TIMED."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = {name: [ms for k, ms in device_events(prof) if name in k]
              for name in kernels}
        missing = [name for name, e in ev.items() if not e]
        if not missing:
            break
        print(f"device_ms: trace {attempt} of {tries} holds no event of "
              f"{missing}")
    else:
        ms = time_ms(fn, reps)
        EVENT_TIMED.append(dict(kernels=list(kernels), ms=ms))
        print(f"device_ms: the profiler saw no launch of {missing} in "
              f"{tries} traces; the whole call timed with CUDA events "
              f"instead: {ms:.4f} ms")
        return ms
    return sum(sum(evs) / len(evs) for evs in ev.values())


# -- work of each kernel at a shape: (bytes each input read once and each
# output written once, arithmetic operations the function needs) --------

# K2's operations, counted line by line from the function itself, the
# plain version emanuel_mixing_plain (regcm_tpu_torch/kernels/
# emanuel_mixing.py; line numbers below are that file's): each add,
# subtract, multiply, divide, min, max, abs and comparison counts one;
# selects, index tests and bit operations none; a term of i alone or of
# j alone is counted once per level, not per pair. Keys: pairs that take
# each branch (emanuel_mixing_plain's counts); "pair" is every pair,
# "level" every (column, level).
K2_OPS = {
    # anum 4, denom 2 (:75-76), fix01 and the divide 3 (:77-78), altem 6
    # (:79), redo test 3 (:81), validity 2 (:90), clip 2 (:100); amp1_e
    # and ad from one row-suffix and two prefix sums of ment, 2 (:171-179)
    "pair": 24,
    "redo": 15,       # :82-87: anum2 4, denom2 4, divide 1, altem 6
    # clip 2 (:100), weight 6 (:153), asij 1 (:156); ment and its
    # normalisation 7 (:97, :155-161); entrained q, u, v 12 (:93-95),
    # elij 1 (:96), summands 6 and their column sums 3 (:185-187)
    "valid": 38,
    "valid_gt": 7,    # j > i: smid, c_cond 2 (:128, :131); awat 2 (:167),
                      # its product and subtraction 2; wdtrain's sum 1
    "valid_le": 3,    # j <= i: smid, sjmax, sjmin (:147-149)
    "c_cond": 2,      # running min, use_min test (:133-135)
    "use_min": 4,     # sjmax, sjmin (:141-146)
    # bf2 7 (:74), cwat 2 (:80), the level terms of anum and redo 4, the
    # row terms of denom 3, scrit 12 (:117-122), asij and fallback 3
    # (:156-162), g * wd 1 (:169)
    "level": 32,
}


def work(k, shape, b, counts=None):
    if k in ("K5b", "K5c"):        # K3, K1 on the block: no halo
        return work(BASE[k], shape, b)
    if k == "K5a":                 # the block's inputs with their 2-wide
        nf, kz, ly, lx = shape     # halo read, the block written
        pe = (ly + 4) * (lx + 4)
        byt = ((nf * kz + 3 * kz + 2 * (kz + 1) + 2) * pe
               + nf * kz * ly * lx) * b
        return byt, 97 * nf * kz * ly * lx
    if k == "K1":                  # c1, c2, c3, rhs in; x out
        n = int(np.prod(shape))    # fwd: 2 mul, 2 sub/add, 2 div; back: 2
        return 5 * n * b, 8 * n
    if k == "K2":                  # 13 profiles + cloud mask in, 8 out;
        ncol, L = shape            # unk, vnk; icb, ict as int64
        byt = (21 * b + 1) * ncol * L + ncol * (2 * b + 16)
        n = dict(counts, pair=ncol * L * L, level=ncol * L,
                 valid_le=counts["valid"] - counts["valid_gt"])
        return byt, sum(K2_OPS[key] * n[key] for key in K2_OPS)
    if k == "K3":                  # wexpl, zm, zp in, w out; w_bot
        n, iy, jx = shape          # up 9 ops a level, down 2
        return (4 * n + 1) * iy * jx * b, 11 * n * iy * jx
    nf, kz, iy, jx = shape         # K4: pp in, out; um, vm, fmz; s, fmzf;
    plane = iy * jx                # mx2, m_ci; ~97 ops a point: one
    byt = (2 * nf * kz + 3 * kz + 2 * (kz + 1) + 2) * plane * b  # flux
    return byt, 97 * nf * kz * plane            # and update per sweep


def bound(k, shape, b, counts=None):
    byt, ops = work(k, shape, b, counts)
    t_b, t_o = byt / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            byt, ops)


def k1_inputs(shape, dtype, dev, seed=0):
    import torch
    rng = np.random.default_rng(seed)
    al = rng.uniform(0.1, 1.0, shape)
    be = rng.uniform(0.1, 1.0, shape)
    bkp = np.concatenate([be[:, 1:], np.zeros_like(be[:, :1])], axis=1)
    c1 = 150.0 * al * bkp
    c3 = 150.0 * al * be
    c3[:, 0] = 0.0
    c2 = 1.0 + c1 + c3
    rhs = rng.normal(size=shape)
    return [torch.as_tensor(a, dtype=dtype, device=dev)
            for a in (c1, c2, c3, rhs)]


def k2_inputs(shape, dtype, dev, seed=0):
    import torch
    ncol, L = shape
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, (ncol, L))
    levels = [f(2.8e5, 3.5e5), f(2.8e5, 3.5e5), f(1e-4, 2e-2),
              f(1e-3, 3e-2), f(200, 300), f(2.3e6, 2.6e6), f(1e-4, 2e-2),
              f(0, 2e-3), f(0, 1), f(0, 0.05), f(-20, 20), f(-20, 20),
              f(5, 60)]
    unk = rng.uniform(-20, 20, ncol)
    vnk = rng.uniform(-20, 20, ncol)
    icb = rng.integers(1, 6, ncol)
    ict = rng.integers(8, L - 2, ncol)
    ii = np.arange(L)[None]
    cloud = (ii >= icb[:, None] + 1) & (ii <= ict[:, None])
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return ([T(a) for a in levels] + [T(unk), T(vnk)]
            + [torch.as_tensor(a, device=dev) for a in (icb, ict, cloud)])


def k3_inputs(shape, dtype, dev, seed=7):
    import torch
    rng = np.random.default_rng(seed)
    n, iy, jx = shape
    arrs = (rng.normal(size=shape), rng.uniform(0.01, 0.5, shape),
            rng.uniform(0.01, 0.5, shape), rng.normal(size=(iy, jx)))
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrs]


def k4_inputs(shape, dtype, dev, seed=11):
    """WAF operands of the MOLOCH step's kind: smooth fields with noise,
    face winds of both signs, s of both signs, metric factors near 1 with
    fmzf = 0 at the model top; dtrdx, dtrdz of dt 30 s at ds 3 km."""
    import torch
    rng = np.random.default_rng(seed)
    nf, kz, iy, jx = shape
    sm = lambda sh: rng.normal(size=sh) + 10.0 * np.sin(
        np.linspace(0, 3, int(np.prod(sh))).reshape(sh))
    pp = sm(shape)
    pp[0] += 300.0
    um = 8.0 + 0.5 * sm((kz, iy, jx))
    vm = -5.0 + 0.5 * sm((kz, iy, jx))
    s = 0.1 * sm((kz + 1, iy, jx))
    fmz = 1.0 + 0.05 * rng.random((kz, iy, jx))
    fmzf = 1.0 + 0.05 * rng.random((kz + 1, iy, jx))
    fmzf[0] = 0.0
    mx2 = 1.0 + 0.01 * rng.random((iy, jx))
    m_ci = np.zeros((iy, jx))
    m_ci[1:iy - 2, 1:jx - 2] = 1.0
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return [T(a) for a in (pp, um, vm, s, fmz, fmzf, mx2, m_ci)] \
        + [30.0 / 3000.0, 30.0 / 199.4]


def compare_kernels(dev, mods):
    """Phase 3: kernel against plain version on the same inputs; returns
    per-kernel stats in f32 at the MOLOCH shape and the test_001 shape."""
    import torch
    make = {"K1": k1_inputs, "K2": k2_inputs, "K3": k3_inputs,
            "K4": k4_inputs}
    stats = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for k, mod in mods.items():
            name = NAMES[k]
            kern = getattr(mod, name)
            plain = getattr(mod, name + "_plain")
            for n, shape in enumerate(SHAPES[k] + EDGE_SHAPES.get(k, [])):
                args = make[k](shape, dtype, dev)
                got = kern(*args)
                counts = {}        # K2's branch counts on these inputs
                want = plain(*args, counts=counts) if k == "K2" \
                    else plain(*args)
                torch.cuda.synchronize()
                if k == "K2":
                    rel, ab = max(rel_err(got[key], want[key])
                                  for key in mod.KEYS)
                else:
                    rel, ab = rel_err(got, want)
                print(f"{k} {name} {dname} {shape}: max rel err {rel:.3e} "
                      f"(max abs {ab:.3e}, tol {TOL[dname][k]:g})")
                if not rel <= TOL[dname][k]:
                    raise AssertionError(f"{k} {dname} {shape} disagrees: "
                                         f"{rel}")
                if dname == "float32" and n < len(SHAPES[k]):
                    b_ms, b_by, byt, ops = bound(k, shape, 4, counts)
                    st = dict(max_abs_err=ab,
                              ms=time_ms(lambda: kern(*args)),
                              device_ms=device_ms(lambda: kern(*args),
                                                  KERNELS[k]),
                              plain_ms=time_ms(lambda: plain(*args)),
                              bound_ms=b_ms, bound_by=b_by, bytes=byt,
                              ops=ops, shape=list(shape))
                    stats.setdefault(k, {})["moloch" if n == 1
                                            else "small"] = st
                    print(f"{k} f32 {shape}: kernel {st['ms']:.4f} ms "
                          f"(device {st['device_ms']:.4f} ms), "
                          f"plain {st['plain_ms']:.4f} ms, bound "
                          f"{b_ms:.4f} ms ({b_by}: {byt / 1e6:.1f} MB, "
                          f"{ops / 1e9:.3f} GFLOP)")
                del args, got, want
                torch.cuda.empty_cache()
    return stats


def rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2))
                 / (np.sqrt(np.mean(b ** 2)) + 1e-30))


def reset(mods):
    for mod in mods.values():
        mod.launches = 0


def read(mods):
    return {k: mod.launches for k, mod in mods.items()}


def hill(iy, jx, seed=5):
    """Seeded Gaussian hill, ~800 m, on the (iy-1, jx-1) cross grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(iy - 1), np.arange(jx - 1),
                         indexing="ij")
    return 800.0 * np.exp(-(((yy - 7.0) / 3.5) ** 2
                            + ((xx - 9.0) / 4.0) ** 2)) \
        + 20.0 * rng.random((iy - 1, jx - 1))


def card_vs_cpu(runs, fields, what):
    """Card against CPU in f64: rel-RMS below max(1e-7, 4 x the CPU
    run's own spread under a 1e-15 relative change of T), and below 1e-7
    without the saturation adjustment (subexparam conf=0)."""
    for f in fields:
        err = rel_rms(runs["gpu"][f], runs["cpu"][f])
        spread = rel_rms(runs["cpu_perturbed"][f], runs["cpu"][f])
        lim = max(1e-7, 4.0 * spread)
        dry_err = rel_rms(runs["gpu_dry"][f], runs["cpu_dry"][f])
        print(f"{what} f64 card vs CPU {f}: rel-RMS {err:.3e} (roundoff "
              f"spread {spread:.3e}, bound {lim:.3e}); without the "
              f"saturation adjustment {dry_err:.3e} (bound 1e-07)")
        if not err < lim:
            raise AssertionError(f"{what}: card and CPU disagree on {f}: "
                                 f"{err}")
        if not dry_err < 1e-7:
            raise AssertionError(f"{what}: card and CPU disagree on {f} "
                                 f"without condensation: {dry_err}")


# -- the CPU side of the card-vs-CPU phases ------------------------------
# Every phase that holds the card to the CPU (5, 7, 14b, 14d, 15c, 16c,
# 17d, 19d, 20c) runs its CPU side in one pool of spawned processes, one
# torch thread each, submitted at the script's start: the CPU runs go on
# while the card runs the phases before them, and each phase reads its
# results when it has run its card side.
CPU_WORKERS = 4


def _cpu_worker_init():
    import torch
    torch.set_num_threads(1)


def cpu_pool():
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(
        max(1, min(CPU_WORKERS, (os.cpu_count() or 2) - 1)),
        mp_context=mp.get_context("spawn"), initializer=_cpu_worker_init)


def trio(submit, fn, *args):
    """Futures of ``fn(*args, device, perturbed, dry)``'s three CPU runs:
    plain, with T changed by 1e-15 relative, without the saturation
    adjustment."""
    return {"cpu": submit(fn, *args, "cpu"),
            "cpu_perturbed": submit(fn, *args, "cpu", True),
            "cpu_dry": submit(fn, *args, "cpu", False, True)}


def spread_runs(submit, fn, *args):
    """Futures of the CPU runs of ``fn(*args, device, conf, seed)`` that
    phases 16c and 17d hold the card to: plain, with the saturation
    adjustment off, and three seeds' 1e-15 changes of T."""
    out = {"cpu": submit(fn, *args, "cpu"),
           "cpu_dry": submit(fn, *args, "cpu", 0.0)}
    for seed in range(3):
        out[f"cpu_perturbed{seed}"] = submit(fn, *args, "cpu", None, seed)
    return out


CPU_DONE = []        # the script's clock as each pooled CPU run ends


def start_cpu_refs(pool):
    """Submit the CPU side of every card-vs-CPU phase to ``pool`` in the
    order the phases read them; the futures by phase."""
    from tests import _torch_chem_settings as S

    def sub(*args, **kw):
        fut = pool.submit(*args, **kw)
        fut.add_done_callback(
            lambda _: CPU_DONE.append(time.time() - _T0[0]))
        return fut
    return {"5": trio(sub, hydro_check_run),
            "7": trio(sub, moloch_check_run),
            "14b": trio(sub, nh_check_run),
            "14d": {o: sub(option_run, o, "cpu") for o in OPTIONS},
            "15c": [{"cpu": sub(scheme_run, i, "cpu"),
                     "cpu_perturbed": sub(scheme_run, i, "cpu", True)}
                    for i in range(len(scheme_cases()))],
            "16c": [spread_runs(sub, cumulus_run, i)
                    for i in range(len(CU_CASES))],
            "17d": [spread_runs(sub, new_case_run, i)
                    for i in range(len(NEW_CASES))],
            "19d": start_chem_cpu(sub, S.SIMS + ("dust_moloch",)),
            "20c": start_gas_cpu(sub)}


def results(futures):
    return {k: f.result() for k, f in futures.items()}


def perturb_t(s0, tn, seed=0):
    """``s0`` with its temperature ``tn`` changed by 1e-15 relative
    (seeded): the roundoff spread's start."""
    import torch
    t = getattr(s0, tn)
    rng = np.random.default_rng(seed)
    return s0._replace(**{tn: t * (1.0 + 1e-15 * torch.as_tensor(
        rng.standard_normal(tuple(t.shape))))})


def hydro_check_run(device, perturbed=False, dry=False):
    """Phase 5's run: Model(RegCMConfig()) in f64 from the 0.3 K
    perturbed rest state for CHECK_STEPS steps on ``device``
    (``perturbed``: T changed by 1e-15; ``dry``: subexparam conf=0);
    the decoupled fields."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model, standard_atmosphere_state
    cfg = RegCMConfig()
    grid = build_grid(cfg)
    s0 = standard_atmosphere_state(grid, cfg, device="cpu",
                                   dtype=torch.float64, perturb=0.3, seed=1)
    if dry:
        cfg.subex.conf = 0.0
    if perturbed:
        s0 = perturb_t(s0, "t_a")
    m = Model(cfg, grid=grid, device=device, dtype=torch.float64,
              initial_state=s0)
    m.run(CHECK_STEPS)
    return m.decoupled()


def moloch_check_run(device, perturbed=False, dry=False):
    """Phase 7's run: MOLOCH in f64 at 16x20x14 over the ~800 m hill
    (ds 10 km, dt 60 s) for CHECK_STEPS steps on ``device``, as
    hydro_check_run; the decoupled fields."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    cfg = RegCMConfig()
    cfg.core.idynamic = 3
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 20, 14
    cfg.geo.ds = 10.0
    cfg.time.dt = 60.0
    grid = build_grid(cfg, ht=hill(16, 20))
    s0 = MolochCore(grid, cfg, device="cpu",
                    dtype=torch.float64).initial_state(perturb=0.3, seed=1)
    if dry:
        cfg.subex.conf = 0.0
    if perturbed:
        s0 = perturb_t(s0, "t")
    m = Model(cfg, grid=grid, device=device, dtype=torch.float64,
              initial_state=s0)
    m.run(CHECK_STEPS)
    if not m.check_finite():
        raise AssertionError(f"non-finite MOLOCH state on {device} "
                             f"(perturbed {perturbed}, dry {dry})")
    return m.decoupled()


def nh_check_run(device, perturbed=False, dry=False):
    """Phase 14b's run: NH in f64 at 16x20x14 over phase 7's hill (ds 10
    km, dt 30 s) for CHECK_STEPS steps on ``device`` (``dry``: the
    dynamics alone, no physics and no saturation adjustment); the NH
    fields."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model, nh_initial_state
    cfg = RegCMConfig()
    cfg.core.idynamic = 2
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 20, 14
    cfg.geo.ds = 10.0
    cfg.time.dt = 30.0
    grid = build_grid(cfg, ht=hill(16, 20))
    s0 = nh_initial_state(grid, cfg, "cpu", torch.float64, perturb=0.3,
                          seed=1)
    if dry:
        cfg.physics.ipptls = 0
    if perturbed:
        s0 = perturb_t(s0, "t_a")
    m = Model(cfg, grid=grid, device=device, dtype=torch.float64,
              initial_state=s0, physics=False if dry else None)
    m.run(CHECK_STEPS)
    if not m.check_finite():
        raise AssertionError(f"non-finite NH state on {device} "
                             f"(perturbed {perturbed}, dry {dry})")
    return nh_fields(m)


def check_run_vs_cpu(dev, fn, cpu, fields, what):
    """Phases 5, 7 and 14b: ``fn``'s card runs (plain and dry) against
    its CPU runs (``cpu``: the futures of trio) by card_vs_cpu."""
    runs = dict(gpu=fn(dev), gpu_dry=fn(dev, False, True))
    runs.update(results(cpu))
    card_vs_cpu(runs, fields, what)


def profile_steps(model, nsteps, what="MOLOCH"):
    """Device busy share and the costliest device kernels over nsteps
    steps (torch.profiler; its own overhead inflates the wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = model.run(nsteps)
    kern = device_events(prof)
    busy_ms = sum(ms for _, ms in kern)
    by_name = {}
    for name, ms in kern:
        by_name[name] = by_name.get(name, 0.0) + ms
    print(f"profile, {nsteps} {what} steps: wall {1e3 * wall:.1f} ms, "
          f"{len(kern)} device kernels ({len(kern) / nsteps:.0f} a step), "
          f"device busy {busy_ms:.2f} ms = "
          f"{100.0 * busy_ms / (1e3 * wall):.2f}% of wall")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms:9.3f} ms  {name[:100]}")


def flagship_cfg():
    from regcm_tpu_torch.config.params import RegCMConfig
    cfg = RegCMConfig()
    cfg.core.idynamic = 3
    cfg.dim.iy = cfg.dim.jx = FLAGSHIP
    cfg.dim.kz = 41
    cfg.geo.ds = 3.0
    cfg.time.dt = 30.0
    return cfg


def hill_cfg(iy, jx):
    from regcm_tpu_torch.config.params import RegCMConfig
    cfg = RegCMConfig()
    cfg.core.idynamic = 3
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = iy, jx, 14
    cfg.geo.ds = 10.0
    cfg.time.dt = 60.0
    return cfg


def compare_decomposed(dev, mods):
    """Phase 9: K5a/b/c on the 2x2 blocks of the MOLOCH-shape inputs,
    each block extended from the global tensors by ``extend_block`` (the
    CPU tests' halo reference), held to the unsharded kernel bit for bit
    and to the plain version; returns the f32 stats of block 0."""
    import torch
    from regcm_tpu_torch.parallel.halo import extend_block
    from regcm_tpu_torch.parallel.mesh import DomainMesh
    k1, k3, k4 = mods["K1"], mods["K3"], mods["K4"]
    modes = ["zero"] * 4 + ["edge"] * 2 + ["zero"] * 2   # K4's operands
    stats = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        calls = {}
        args = k4_inputs(SHAPES["K4"][1], dtype, dev)
        ops, (dtrdx, dtrdz) = args[:8], args[8:]
        iy, jx = ops[0].shape[-2:]
        meshes = [DomainMesh(*GRID, iy, jx, rank=r)
                  for r in range(GRID[0] * GRID[1])]

        def waf_blocks(m):
            ext = [extend_block(a, m.y0, m.x0, m.ly, m.lx, 2, mode)
                   for a, mode in zip(ops, modes)]
            geo = (dtrdx, dtrdz, iy, jx, m.y0, m.x0)
            return (lambda: k4.waf_advect_halo(*ext, *geo),
                    lambda: k4.waf_advect_sharded_plain(*ext, *geo))
        calls["K5a"] = (lambda: k4.waf_advect(*args),
                        [waf_blocks(m) for m in meshes],
                        (SHAPES["K4"][1][0], SHAPES["K4"][1][1],
                         meshes[0].ly, meshes[0].lx))
        for k, mod, name, make, full in (
                ("K5b", k3, "tridiag_w", k3_inputs, SHAPES["K3"][1]),
                ("K5c", k1, "pbl_tridiag", k1_inputs, SHAPES["K1"][1])):
            arrs = make(full, dtype, dev)
            sharded = getattr(mod, name + "_sharded")
            plain = getattr(mod, name + "_plain")

            def blocks(m, arrs=arrs, sharded=sharded, plain=plain):
                loc = [m.local(a) for a in arrs]
                return (lambda: sharded(m, *loc), lambda: plain(*loc))
            calls[k] = (lambda arrs=arrs, mod=mod, name=name:
                        getattr(mod, name)(*arrs),
                        [blocks(m) for m in meshes],
                        tuple(full[:-2]) + (meshes[0].ly, meshes[0].lx))
        for k, (whole, per_block, bshape) in calls.items():
            want = whole()
            got = [kern() for kern, _ in per_block]
            ref = [plain() for _, plain in per_block]
            torch.cuda.synchronize()
            cat = lambda bl: torch.cat([torch.cat(bl[py * GRID[1]:(py + 1)
                                                     * GRID[1]], dim=-1)
                                        for py in range(GRID[0])], dim=-2)
            got, ref = cat(got), cat(ref)
            same = torch.equal(got, want)
            rel, ab = rel_err(got, ref)
            print(f"{k} {NAMES[k]} {dname} 2x2 blocks of {tuple(want.shape)}"
                  f": {'bit-identical' if same else 'DIFFERENT'} to the "
                  f"unsharded {BASE[k]}; against the plain version max "
                  f"rel err {rel:.3e} (max abs {ab:.3e}, tol "
                  f"{TOL[dname][k]:g})")
            if not same:
                raise AssertionError(f"{k} {dname}: the blocks differ from "
                                     f"the unsharded {BASE[k]} by "
                                     f"{float((got - want).abs().max())}")
            if not rel <= TOL[dname][k]:
                raise AssertionError(f"{k} {dname} disagrees with its plain "
                                     f"version: {rel}")
            if dname == "float32":
                kern, plain = per_block[0]
                b_ms, b_by, byt, nops = bound(k, bshape, 4)
                st = dict(max_abs_err=ab, ms=time_ms(kern),
                          device_ms=device_ms(kern, KERNELS[BASE[k]]),
                          plain_ms=time_ms(plain), bound_ms=b_ms,
                          bound_by=b_by, bytes=byt, ops=nops,
                          shape=list(bshape))
                stats[k] = {"moloch": st}
                print(f"{k} f32 block {bshape}: kernel {st['ms']:.4f} ms "
                      f"(device {st['device_ms']:.4f} ms), "
                      f"plain {st['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}: {byt / 1e6:.2f} MB, {nops / 1e9:.3f} "
                      f"GFLOP)")
            del want, got, ref
        del calls, args, ops
        torch.cuda.empty_cache()
    return stats


def compare_uneven(dev, k4):
    """Phase 9, second part: K5a on blocks of unequal size, the small K4
    shape cut at UNEVEN's row and column edges, each block extended by
    ``extend_block`` and held to the unsharded K4 bit for bit."""
    import torch
    from regcm_tpu_torch.parallel.halo import extend_block
    shape, ys, xs = UNEVEN
    modes = ["zero"] * 4 + ["edge"] * 2 + ["zero"] * 2
    for dtype in (torch.float64, torch.float32):
        args = k4_inputs(shape, dtype, dev)
        ops, (dtrdx, dtrdz) = args[:8], args[8:]
        iy, jx = shape[-2:]
        want = k4.waf_advect(*args)
        rows = []
        for y0, y1 in zip(ys[:-1], ys[1:]):
            row = []
            for x0, x1 in zip(xs[:-1], xs[1:]):
                ext = [extend_block(a, y0, x0, y1 - y0, x1 - x0, 2, mode)
                       for a, mode in zip(ops, modes)]
                row.append(k4.waf_advect_halo(*ext, dtrdx, dtrdz, iy, jx,
                                              y0, x0))
            rows.append(torch.cat(row, dim=-1))
        got = torch.cat(rows, dim=-2)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        sizes = [(y1 - y0, x1 - x0) for y0, y1 in zip(ys[:-1], ys[1:])
                 for x0, x1 in zip(xs[:-1], xs[1:])]
        print(f"K5a {NAMES['K5a']} {str(dtype).split('.')[-1]} uneven "
              f"{len(ys) - 1}x{len(xs) - 1} blocks {sizes} of {shape}: "
              f"{'bit-identical' if same else 'DIFFERENT'} to the unsharded "
              f"K4")
        if not same:
            raise AssertionError(f"K5a {dtype} on the uneven split differs "
                                 f"from K4 by "
                                 f"{float((got - want).abs().max())}")


def dryrun(cfg, grid, device, mesh=None, steps=3):
    """dryrun_multichip's MOLOCH setting: three full-physics f64 steps
    from the 0.2 K perturbed rest state, every alarm on step 0, surface
    and cumulus after, cos(zenith) 0.4; the whole domain's prognostics."""
    import torch
    from regcm_tpu_torch.core.state import StepFlags
    from regcm_tpu_torch.driver import moloch_bdy_from_state
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.physics.suite import PhysicsSuite
    f64 = torch.float64
    core = MolochCore(grid, cfg, device=device, dtype=f64, mesh=mesh,
                      physics=PhysicsSuite(cfg, grid, device, f64,
                                           mesh=mesh))
    st = core.initial_state(perturb=0.2)
    bdy = moloch_bdy_from_state(st)
    mu = torch.full_like(st.tg, 0.4)
    for n in range(steps):
        flags = StepFlags(do_rad=True, do_srf=True, do_cum=True,
                          do_abem=True, first=True) if n == 0 \
            else StepFlags(do_rad=False, do_srf=True, do_cum=True)
        st, _ = core.step(st, bdy, n * cfg.dtsec, cfg.dtsec, flags, mu,
                          (1.0343, 1361.8))
    out = {k: getattr(st, k) for k in ("pai", "t", "u", "v", "w", "qx")}
    if mesh is not None:
        out = {k: mesh.gather(v) for k, v in out.items()}
    return {k: v.cpu().numpy() for k, v in out.items()}


def hydro_dryrun(device, physics, mesh=None):
    """dryrun_multichip's hydrostatic settings at 16x16x14 in f64, three
    steps through HydroCore.step from the perturbed standard atmosphere
    with a 10 m/s jet and qv lifted off the minqq floor: dynamics
    (ipptls 0, 0.3 K, constant flags) or full physics (0.2 K, every alarm
    at step 0, surface and cumulus after, cos(zenith) 0.4). The whole
    domain's state fields (nonzero size) after step 3."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.core.state import StepFlags, bdy_from_state, sliced
    from regcm_tpu_torch.driver import Model, standard_atmosphere_state
    from regcm_tpu_torch.dynamics.stencil import cross2dot
    f64 = torch.float64
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 16, 14
    if not physics:
        cfg.physics.ipptls = 0
    grid = build_grid(cfg)
    m = Model(cfg, grid=grid, device=device, dtype=f64, mesh=mesh,
              physics=None if physics else False)
    s = standard_atmosphere_state(grid, cfg, "cpu", f64,
                                  perturb=0.2 if physics else 0.3,
                                  seed=3 if physics else 0)
    u = 10.0 * cross2dot(s.ps_a)[None] * torch.ones_like(s.u_a)
    qv = torch.maximum(s.qx_a[0], 1e-5 * s.ps_a[None])
    qx = torch.cat([qv[None], s.qx_a[1:]])
    s = s._replace(u_a=u, u_b=u, qx_a=qx, qx_b=qx, tg=s.t_a[-1] / s.ps_a
                   if physics else s.tg)
    s = sliced(s, mesh)
    s = s._replace(**{k: v.to(device) for k, v in s._asdict().items()})
    if physics:
        s = s._replace(bats=m.state.bats)
    s = m.core.init_split_storage(s)
    bdy = bdy_from_state(s)
    mu = torch.full_like(s.tg, 0.4)
    xt, dt = 0.0, cfg.dtsec
    for n in range(3):
        if physics:
            flags = StepFlags(do_rad=True, do_srf=True, do_cum=True,
                              do_abem=True, first=True) if n == 0 \
                else StepFlags(do_rad=False, do_srf=True, do_cum=True)
            s, _ = m.core.step(s, bdy, xt, dt, flags, mu, (1.0343, 1361.8))
        else:
            s, _ = m.core.step(s, bdy, xt, dt, StepFlags(first=True))
        xt += cfg.dtsec
        dt = 2.0 * cfg.dtsec
    f = {k: v for k, v in s._asdict().items() if v.numel()}
    if mesh is not None:
        f = {k: mesh.gather(v) for k, v in f.items()}
    return {k: v.cpu().numpy() for k, v in f.items()}


def hydro_icbc_cfg():
    """test_001 (RegCMConfig()) over phase 13's one-day ICBC window."""
    from regcm_tpu_torch.config.params import RegCMConfig
    cfg = RegCMConfig()
    cfg.globdat.gdate2 = ICBC_END
    return cfg


def write_icbc_files(directory):
    """Phase 13's input files, written by the port's preprocessors: the
    test_001 DOMAIN file of a 500 m hill and its one-day ICBC file, and
    the MOLOCH flagship's (flat) one-day ICBC file, both with a 10 m/s
    jet."""
    from regcm_tpu_torch.preproc.icbc import generate_synthetic_icbc
    from regcm_tpu_torch.preproc.terrain import synthetic_topo, write_domain
    paths = {}
    hcfg = hydro_icbc_cfg()
    topo, lnd, mask = synthetic_topo(hcfg, kind="gauss", height=500.0)
    paths["domain"] = os.path.join(directory, "test_001_DOMAIN000.nc")
    write_domain(hcfg, paths["domain"], topo, lnd, mask)
    paths["hydro"] = os.path.join(directory, "test_001_ICBC.nc")
    generate_synthetic_icbc(hcfg, topo, paths["hydro"], jet=10.0)
    mcfg = flagship_cfg()
    mcfg.globdat.gdate2 = ICBC_END
    topo, _, _ = synthetic_topo(mcfg, kind="flat")
    paths["moloch"] = os.path.join(directory, "moloch_ICBC.nc")
    generate_synthetic_icbc(mcfg, topo, paths["moloch"], jet=10.0)
    return paths


def hydro_icbc_model(paths, device, mesh=None, dtype=None, physics=None):
    """test_001 in f32 on the DOMAIN file's grid, cold-started from the
    ICBC file (the rank's block under a mesh), with the physicsparam
    overrides ``physics``."""
    import torch
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    cfg = with_physics(hydro_icbc_cfg(), physics or {})
    grid = build_grid_from_domain(cfg, paths["domain"])
    m = Model(cfg, grid=grid, device=device, dtype=dtype or torch.float32,
              mesh=mesh)
    m.init_from_icbc(ICBCReader(paths["hydro"], cfg.globdat.calendar))
    return m


def icbc_steps(model, until, record=(), stop_non_finite=False, chain=None):
    """run_icbc one step at a time up to step ``until``: each step's
    number, whether radiation ran and its wall ms (synchronised), the
    decoupled fields after the steps in ``record``, and the first step
    after which the state was not finite (None if it stayed finite; with
    ``stop_non_finite`` the run checks each step and stops there). A
    phase 18a ``Chain`` sees the model after each (untimed)."""
    steps, rec, bad = [], {}, None
    while model.nstep < until:
        rad = model._flags().do_rad
        _, wall = model.run_icbc(1)
        steps.append((model.nstep - 1, rad, 1000.0 * wall))
        if chain is not None:
            chain(model)
        if stop_non_finite and not model.check_finite():
            bad = model.nstep
            break
        if model.nstep in record:
            rec[model.nstep] = model.decoupled()
    return steps, rec, bad


def mean_ms(steps, lo, hi, rad):
    """Mean ms of the steps lo..hi-1 whose radiation flag is ``rad``."""
    ms = [t for n, r, t in steps if lo <= n < hi and r == rad]
    return sum(ms) / len(ms), len(ms)


def run_icbc_single(dev, smi, paths, mods, chains=None):
    """Phase 13: the ICBC-driven runs on one card; returns 13a's decoupled
    fields at HYDRO_CHECK and step 150, its boundary clock at step 150
    and its mean ms/step over HYDRO_CHECK's window. Phase
    18a's ``chains`` ("test_001", "MOLOCH") ride on 13a and 13b."""
    chains = chains or {}
    import torch
    # -- 13a. test_001 from the ICBC file, f32, through step 150
    t0 = time.time()
    model = hydro_icbc_model(paths, dev)
    torch.cuda.synchronize()
    print(f"ICBC test_001: {model.grid.jx}x{model.grid.iy}x{model.grid.kz}"
          f", set-up and init_from_icbc {time.time() - t0:.1f} s")
    reset(mods)
    steps, rec, _ = icbc_steps(model, HYDRO_ICBC_STEPS,
                               HYDRO_CHECK + (HYDRO_ICBC_STEPS,),
                               chain=chains.get("test_001"))
    launches = read(mods)
    print(f"ICBC test_001 path: {HYDRO_ICBC_STEPS} steps, launches "
          f"{launches}, boundary clock {model.xbctime:.0f} s after the "
          f"update at step 144")
    if not model.check_finite():
        raise AssertionError("ICBC test_001: non-finite state")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"ICBC test_001 bypassed a kernel: {launches}")
    if model.xbctime >= 6 * 3600.0:
        raise AssertionError("ICBC test_001: no boundary update")
    d = rec[HYDRO_ICBC_STEPS]
    print(f"ICBC test_001 step {HYDRO_ICBC_STEPS}: ps {d['ps'].min():.3f}.."
          f"{d['ps'].max():.3f} hPa, T {d['t'].min():.3f}..{d['t'].max():.3f}"
          f" K, max |u| {np.abs(d['u']).max():.3f} m/s")
    plain, n_plain = mean_ms(steps, 1, HYDRO_ICBC_STEPS, False)
    rad, n_rad = mean_ms(steps, 1, HYDRO_ICBC_STEPS, True)
    print(f"ICBC test_001 ms/step (f32, 34x48x18, steps 1..149, each "
          f"synchronised): {plain:.3f} over the {n_plain} steps without "
          f"radiation, {rad:.3f} over the {n_rad} radiation steps, on {smi}")
    window = [t for n, _, t in steps
              if HYDRO_CHECK[0] <= n < HYDRO_CHECK[1]]
    xbctime = model.xbctime
    del model
    torch.cuda.empty_cache()

    # -- 13b. the MOLOCH flagship from its ICBC file, f32, through step 61
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    model = moloch_icbc_model(paths, dev)
    torch.cuda.synchronize()
    print(f"ICBC MOLOCH 192x192x41: set-up and init_from_icbc "
          f"{time.time() - t0:.1f} s")
    reset(mods)
    marks = (12, 24, 36, 48, MOLOCH_ICBC_STEPS)
    steps, mrec, bad = icbc_steps(model, MOLOCH_ICBC_STEPS, marks,
                                  stop_non_finite=True,
                                  chain=chains.get("MOLOCH"))
    mlaunch = read(mods)
    print(f"ICBC MOLOCH path: {len(steps)} steps, launches {mlaunch}")
    if min(mlaunch.values()) <= 0:
        raise AssertionError(f"ICBC MOLOCH bypassed a kernel: {mlaunch}")
    # a finding, not a failure: how this start evolves, and whether it
    # goes non-finite by step 61
    for n, d in mrec.items():
        print(f"ICBC MOLOCH step {n}: ps {d['ps'].min():.3f}.."
              f"{d['ps'].max():.3f} hPa, wmax {np.abs(d['w']).max():.4f} "
              f"m/s, max |u| {np.abs(d['u']).max():.3f} m/s")
    print(f"ICBC MOLOCH 192x192x41 f32 from the ICBC start: "
          + (f"non-finite after step {bad}" if bad is not None
             else f"finite through step {model.nstep}"))
    if bad is None or bad > 47:
        ms, n = mean_ms(steps, STEPS, 2 * STEPS, False)
        print(f"ICBC MOLOCH ms/step (f32, 192x192x41, steps {STEPS}.."
              f"{2 * STEPS - 1}, {n} steps, each synchronised): {ms:.3f} on "
              f"{smi}")
    radn = [t for n, r, t in steps if r and n == RAD_STEP]
    if radn:
        print(f"ICBC MOLOCH radiation step (step {RAD_STEP}: radiation, "
              f"surface, cumulus; synchronised): {radn[0]:.3f} ms on {smi}")
    print(f"ICBC MOLOCH peak device memory (steps 0..{model.nstep}): "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    return dict(rec=rec, window_ms=sum(window) / len(window),
                xbctime=xbctime)


def moloch_icbc_model(paths, device, init=True):
    """The MOLOCH flagship in f32 over phase 13's one-day ICBC window,
    cold-started from its ICBC file unless ``init`` is false."""
    import torch
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    mcfg = flagship_cfg()
    mcfg.globdat.gdate2 = ICBC_END
    model = Model(mcfg, grid=build_grid(mcfg), device=device,
                  dtype=torch.float32)
    if init:
        model.init_from_icbc(ICBCReader(paths["moloch"],
                                        mcfg.globdat.calendar))
    return model


def hydro_spread(dev, paths):
    """The f32 rule's spread: phase 13a's run again with T changed by
    1e-7 relative right after the cold start; its decoupled fields at
    HYDRO_CHECK."""
    import torch
    model = hydro_icbc_model(paths, dev)
    t = model.state.t_a
    rng = np.random.default_rng(0)
    noise = torch.as_tensor(rng.standard_normal(tuple(t.shape)),
                            dtype=t.dtype, device=t.device)
    model.state = model.state._replace(t_a=t * (1.0 + 1e-7 * noise))
    _, rec, _ = icbc_steps(model, HYDRO_CHECK[1], HYDRO_CHECK)
    del model
    torch.cuda.empty_cache()
    return rec


def decomposed_rank(rank, time_steps, paths):
    """Phases 10-12, 14c, 15e, 16d, 17b, 18b and 18d on one rank of a 2x2
    group: the flagship in f32 for DECOMP_STEPS steps (counters reset
    just before, read just after), the whole domain's fields at the end
    (on rank 0), the ms/step of ``time_steps`` steps from TIME_START;
    the f64 MOLOCH dryrun; the f64 hydrostatic dryruns; test_001 from the
    ICBC files in ``paths`` (counters reset just before, read just after)
    with the whole domain's fields at HYDRO_CHECK (on rank 0) and the
    ms/step after step 12, and from phase 13a's SAV after step 138 past
    the boundary update to step 150; then the later phases' rank
    functions."""
    import torch
    import torch.distributed as dist
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.kernels import tridiag_w as k3
    from regcm_tpu_torch.kernels import waf_advect as k4
    from regcm_tpu_torch.parallel import halo
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    laps, t_lap = {}, [time.time()]

    def lap(part):              # the seconds of each part on this rank
        laps[part] = round(time.time() - t_lap[0], 1)
        t_lap[0] = time.time()
    dev = rank.device
    cfg = flagship_cfg()
    grid = build_grid(cfg)
    mesh = rank.mesh(grid.iy, grid.jx)
    torch.cuda.reset_peak_memory_stats(dev)
    s0 = MolochCore(grid, cfg, device=dev, dtype=torch.float32,
                    mesh=mesh).initial_state(perturb=0.3, seed=1)
    model = Model(cfg, grid=grid, device=dev, dtype=torch.float32,
                  initial_state=s0, mesh=mesh)
    del s0
    mods = {"K1": k1, "K2": k2, "K3": k3, "K4": k4}
    for m in mods.values():
        m.launches = 0
    k1.launches_sharded = k3.launches_sharded = k4.launches_sharded = 0
    halo.exchanges = halo.bytes_sent = 0
    model.run(DECOMP_STEPS)
    launches = {k: m.launches for k, m in mods.items()}
    launches.update(K5a=k4.launches_sharded, K5b=k3.launches_sharded,
                    K5c=k1.launches_sharded)
    exch = (halo.exchanges / DECOMP_STEPS, halo.bytes_sent / DECOMP_STEPS)
    finite = model.check_finite()
    dec = model.decoupled()
    model.run(TIME_START - DECOMP_STEPS)
    dist.barrier()
    _, wall = model.run(time_steps)
    walls = [None] * rank.world
    dist.all_gather_object(walls, wall)
    out = dict(launches=launches, exchanges_per_step=exch[0],
               bytes_per_step=exch[1], finite=finite,
               ms_per_step=1000.0 * max(walls) / time_steps,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               device=str(dev), backend=rank.backend,
               dec=dec if rank.rank == 0 else None)
    del model
    torch.cuda.empty_cache()
    lap("10")
    hcfg = hill_cfg(32, 32)
    hgrid = build_grid(hcfg, ht=hill(32, 32))
    d64 = dryrun(hcfg, hgrid, dev, rank.mesh(32, 32))
    out["dryrun"] = d64 if rank.rank == 0 else None
    # -- 12a. the hydrostatic core in f64, dryrun_multichip's settings
    hd = {ph: hydro_dryrun(dev, ph, rank.mesh(16, 16))
          for ph in (False, True)}
    out["hydro_dryrun"] = hd if rank.rank == 0 else None
    lap("11, 12a")
    # -- 12b. test_001 from the ICBC files, f32, HYDRO_CHECK[1] steps
    model = hydro_icbc_model(paths, dev, rank.mesh(34, 48))
    for m in mods.values():
        m.launches = 0
    k1.launches_sharded = k3.launches_sharded = k4.launches_sharded = 0
    halo.exchanges = halo.bytes_sent = 0
    model.run_icbc(HYDRO_CHECK[0])
    dec = {HYDRO_CHECK[0]: model.decoupled()}
    dist.barrier()
    _, wall = model.run_icbc(HYDRO_CHECK[1] - HYDRO_CHECK[0])
    launches = {k: m.launches for k, m in mods.items()}
    launches.update(K5a=k4.launches_sharded, K5b=k3.launches_sharded,
                    K5c=k1.launches_sharded)
    walls = [None] * rank.world
    dist.all_gather_object(walls, wall)
    out["hydro"] = dict(
        launches=launches, finite=model.check_finite(),
        xbctime=model.xbctime,
        exchanges_per_step=halo.exchanges / HYDRO_CHECK[1],
        bytes_per_step=halo.bytes_sent / HYDRO_CHECK[1],
        ms_per_step=1000.0 * max(walls)
        / (HYDRO_CHECK[1] - HYDRO_CHECK[0]))
    dec[HYDRO_CHECK[1]] = model.decoupled()
    out["hydro"]["dec"] = dec if rank.rank == 0 else None
    del model
    lap("12b")
    # -- 12b. the boundary update under the mesh: phase 13a's SAV after
    # step CHAIN_STEPS["test_001"][0] (phase 18a's) into a fresh 2x2
    # Model, run past the update after step 144 to step 150
    model = hydro_icbc_model(paths, dev, rank.mesh(34, 48))
    model.load_restart(os.path.join(paths["phase18"], "test_001_SAV.nc"))
    model.attach_icbc(ICBCReader(paths["hydro"],
                                 model.cfg.globdat.calendar))
    k1.launches_sharded = 0
    model.run_icbc(HYDRO_ICBC_STEPS - model.nstep)
    dec = model.decoupled()
    out["hydro"]["update"] = dict(
        finite=model.check_finite(), xbctime=model.xbctime,
        k5c=k1.launches_sharded, dec=dec if rank.rank == 0 else None)
    del model
    torch.cuda.empty_cache()
    lap("12b update")
    for part, key, fn, args in (
            ("14c", "nh", nh_rank, (time_steps,)),
            ("15e", "schemes", schemes_rank, (paths,)),
            ("16d", "cumulus", cumulus_rank, (paths,)),
            ("17b", "band", band_rank, (paths,)),
            ("18b, 18d", "sl", sl_rank, (paths,)),
            ("19e", "chem", chem_rank, (paths,)),
            ("20d", "gas", gas_rank, (paths,))):
        out[key] = fn(rank, *args)
        lap(part)
    out["laps"] = laps
    return out


def nh_rank(rank, time_steps):
    """Phase 14c on one rank of the 2x2 group: the NH flagship in f32 for
    DECOMP_STEPS steps (counters reset just before, read just after), the
    whole domain's fields at the end (on rank 0), then the ms/step of
    ``time_steps`` steps from TIME_START."""
    import torch
    import torch.distributed as dist
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.kernels import tridiag_w as k3
    from regcm_tpu_torch.kernels import waf_advect as k4
    from regcm_tpu_torch.parallel import halo
    mods = {"K1": k1, "K2": k2, "K3": k3, "K4": k4}
    dev = rank.device
    ncfg = nh_flagship_cfg()
    ngrid = build_grid(ncfg)
    model = nh_model(ncfg, ngrid, dev, rank.mesh(ngrid.iy, ngrid.jx))
    reset(mods)
    k1.launches_sharded = k3.launches_sharded = k4.launches_sharded = 0
    halo.exchanges = halo.bytes_sent = 0
    model.run(DECOMP_STEPS)
    launches = read(mods)
    launches.update(K5a=k4.launches_sharded, K5b=k3.launches_sharded,
                    K5c=k1.launches_sharded)
    nh = dict(launches=launches, finite=model.check_finite(),
              exchanges_per_step=halo.exchanges / DECOMP_STEPS,
              bytes_per_step=halo.bytes_sent / DECOMP_STEPS)
    dec = nh_fields(model)
    nh["dec"] = dec if rank.rank == 0 else None
    model.run(TIME_START - DECOMP_STEPS)
    dist.barrier()
    _, wall = model.run(time_steps)
    walls = [None] * rank.world
    dist.all_gather_object(walls, wall)
    nh["ms_per_step"] = 1000.0 * max(walls) / time_steps
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return nh


def run_decomposed(dev, smi, single12, paths, icbc13, nh12, a15, c16, d17,
                   e19, g20):
    """Phases 10-12, 14c, 15e, 16d, 17b, 18b and 18d: the 2x2 groups of
    ``decomposed_rank`` on every backend the host allows, held bit for
    bit to the single card's step-12 fields ``single12`` and to its f64
    dryruns, test_001 from ICBC to phase 13a's run ``icbc13``, the NH
    flagship bit for bit to phase 14a's step-12 fields ``nh12``,
    configurations A, C and D to their single-card step-12 fields
    ``a15``, ``c16`` and ``d17``, the CRM to one card in f64, the
    semi-Lagrangian test_001 to one card (``sl_single``), E's settings
    on test_001's widths to one card's step-12 fields ``e19`` and CBMZ on
    test_001's widths to one card's ``g20``; returns each backend's rank
    results."""
    import torch
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.parallel.launch import spawn
    # phases 11 and 12a's single-card references
    hcfg = hill_cfg(32, 32)
    hgrid = build_grid(hcfg, ht=hill(32, 32))
    ref64 = dryrun(hcfg, hgrid, dev)
    href = {ph: hydro_dryrun(dev, ph) for ph in (False, True)}
    crm_ref = crm_run(dev)                   # 17b's single-card CRM
    sl_ref = sl_single(dev, paths)           # 18b, 18d's single card
    spread = None                 # the f32 rule's spread run, if needed
    ncards = torch.cuda.device_count()
    world = GRID[0] * GRID[1]
    cards = (f"{ncards} cards: one card a rank" if ncards >= world
             else f"{ncards} card(s) for {world} ranks")
    why = {"gloo": f"{cards}, halos staged through host memory",
           "nccl": cards}
    backends = ["gloo"]
    if ncards >= world:
        backends.append("nccl")
    else:
        print(f"decomposed runs: nccl not run: it needs a card for each "
              f"of the {world} ranks, this host has {ncards}")
    decomp = {}
    for backend in backends:
        print(f"decomposed runs: {GRID[0]}x{GRID[1]} ranks, {backend} "
              f"({why[backend]})")
        t0 = time.time()
        res = spawn(decomposed_rank, *GRID, backend, "cuda",
                    args=(TIME_STEPS, paths), timeout=900)
        print(f"  {backend} group ran in {time.time() - t0:.1f} s; rank 0's "
              f"seconds by phase {res[0]['laps']}")
        for r, out in enumerate(res):
            print(f"  rank {r} on {out['device']}: launches "
                  f"{out['launches']}, {out['exchanges_per_step']:.1f} "
                  f"halo exchanges and {out['bytes_per_step'] / 1e6:.3f} MB "
                  f"sent a step, peak device memory {out['peak_gib']:.2f} "
                  f"GiB")
            if not out["finite"]:
                raise AssertionError(f"rank {r}: non-finite state after "
                                     f"{DECOMP_STEPS} decomposed steps")
            for k in ("K5a", "K5b", "K5c"):
                if out["launches"][k] <= 0:
                    raise AssertionError(f"rank {r} ({backend}): the "
                                         f"decomposed path bypassed {k}")
        dec = res[0]["dec"]
        for f in ("ps", "t", "qv", "u", "v", "w"):
            err = rel_rms(dec[f], single12[f])
            same = np.array_equal(dec[f], single12[f])
            print(f"  MOLOCH 192x192x41 f32 step {DECOMP_STEPS}, {backend} "
                  f"2x2 vs one card, {f}: "
                  f"{'bit-identical' if same else 'DIFFERENT'}, rel-RMS "
                  f"{err:.3e}")
            # every operation of a column is the same whatever its block
            # (the kernels' halo forms test the domain on global indices)
            if not same:
                raise AssertionError(f"decomposed flagship ({backend}) "
                                     f"differs from one card in {f}: "
                                     f"rel-RMS {err}")
        ms = res[0]["ms_per_step"]
        last = TIME_START + TIME_STEPS - 1
        print(f"  decomposed MOLOCH ms/step (f32, 192x192x41 on 2x2 ranks, "
              f"{backend}, steps {TIME_START}..{last}: cumulus and "
              f"surface at 20, no radiation; synchronised, slowest rank): "
              f"{ms:.3f} on {smi}")
        # -- 11. f64 at 32x32x14 over the hill, 2x2 against one card
        d64 = res[0]["dryrun"]
        for f, want in ref64.items():
            rel = float(np.max(np.abs(d64[f] - want))
                        / max(float(np.max(np.abs(want))), 1e-300))
            print(f"  MOLOCH 32x32x14 f64 dryrun, {backend} 2x2 vs one "
                  f"card, {f}: max rel err {rel:.3e} (bound 1e-12)")
            if not rel <= 1e-12:
                raise AssertionError(f"decomposed f64 dryrun ({backend}) "
                                     f"disagrees in {f}: {rel}")
        # -- 12a. the hydrostatic core, f64, 16x16x14, 2x2 against one card
        for ph, want in href.items():
            got = res[0]["hydro_dryrun"][ph]
            what = "full physics" if ph else "dynamics"
            worst = max((max_rel(got[f], w), f) for f, w in want.items())
            same = all(np.array_equal(got[f], w) for f, w in want.items())
            print(f"  hydrostatic 16x16x14 f64 dryrun ({what}, 3 steps), "
                  f"{backend} 2x2 vs one card: "
                  f"{'bit-identical' if same else 'DIFFERENT'}, worst "
                  f"field {worst[1]} max rel err {worst[0]:.3e} (bound "
                  f"1e-12)")
            if not worst[0] <= 1e-12:
                raise AssertionError(f"decomposed hydrostatic f64 dryrun "
                                     f"({backend}, {what}) disagrees in "
                                     f"{worst[1]}: {worst[0]}")
        # -- 12b. test_001 from ICBC on 2x2 ranks against phase 13a
        for r, out in enumerate(res):
            h = out["hydro"]
            print(f"  rank {r} hydrostatic test_001 ICBC: launches "
                  f"{h['launches']}, {h['exchanges_per_step']:.1f} halo "
                  f"exchanges and {h['bytes_per_step'] / 1e6:.3f} MB sent a "
                  f"step")
            if not h["finite"]:
                raise AssertionError(f"rank {r}: non-finite decomposed "
                                     f"test_001 state")
            if h["launches"]["K5c"] <= 0 or h["launches"]["K2"] <= 0 \
                    or h["launches"]["K1"] != 0:
                raise AssertionError(f"rank {r} ({backend}): the "
                                     f"decomposed test_001 path bypassed "
                                     f"K5c or K2: {h['launches']}")
            if h["xbctime"] != HYDRO_CHECK[1] * hydro_icbc_cfg().dtsec:
                raise AssertionError(f"rank {r}: the boundary clock is "
                                     f"{h['xbctime']} s")
        dec = res[0]["hydro"]["dec"]
        same = all(np.array_equal(dec[n][f], icbc13["rec"][n][f])
                   for n in HYDRO_CHECK for f in HYDRO_FIELDS)
        if not same and spread is None:
            spread = hydro_spread(dev, paths)
        for n in HYDRO_CHECK:
            for f in HYDRO_FIELDS:
                want = icbc13["rec"][n][f]
                err = rel_rms(dec[n][f], want)
                line = (f"  test_001 ICBC f32 step {n}, {backend} 2x2 vs one "
                        f"card, {f}: "
                        f"{'bit-identical' if np.array_equal(dec[n][f], want) else 'DIFFERENT'}"
                        f", rel-RMS {err:.3e}")
                if not same:
                    lim = 4.0 * rel_rms(spread[n][f], want)
                    line += f" (f32 rule: bound 4 x spread = {lim:.3e})"
                    if not err < lim:
                        raise AssertionError(f"decomposed test_001 "
                                             f"({backend}) differs from one "
                                             f"card in {f} at step {n}: "
                                             f"{err} >= {lim}")
                print(line)
        print(f"  decomposed test_001 held to one card "
              + ("bit for bit" if same else
                 "by the f32 rule (four times the single card's rel-RMS "
                 "spread under a 1e-7 change of T; not bit-identical)"))
        # the boundary update under the mesh: 13a's SAV after step
        # CHAIN_STEPS["test_001"][0] run on 2x2 ranks to step 150
        at = CHAIN_STEPS["test_001"][0]
        for r, out in enumerate(res):
            u = out["hydro"]["update"]
            if not u["finite"] or u["k5c"] <= 0:
                raise AssertionError(f"rank {r} ({backend}): the update "
                                     f"run is not finite or bypassed K5c: "
                                     f"{u['k5c']}")
            if u["xbctime"] != icbc13["xbctime"]:
                raise AssertionError(f"rank {r} ({backend}): boundary clock "
                                     f"{u['xbctime']} s after step "
                                     f"{HYDRO_ICBC_STEPS}, one card "
                                     f"{icbc13['xbctime']} s")
        dec = res[0]["hydro"]["update"]["dec"]
        want = icbc13["rec"][HYDRO_ICBC_STEPS]
        bad = [f for f in HYDRO_FIELDS if not np.array_equal(dec[f], want[f])]
        print(f"  test_001 ICBC f32 from phase 13a's SAV after step {at} on "
              f"2x2 ranks ({backend}), past the boundary update after step "
              f"144 (boundary clock {res[0]['hydro']['update']['xbctime']:.0f}"
              f" s), step {HYDRO_ICBC_STEPS} vs one card: "
              + (f"bit-identical in {', '.join(HYDRO_FIELDS)}" if not bad
                 else f"DIFFERENT in {bad}"))
        if bad:
            raise AssertionError(f"decomposed test_001 ({backend}) after the "
                                 f"boundary update differs from one card "
                                 f"in {bad}")
        print(f"  decomposed test_001 ms/step (f32, 34x48x18 from ICBC on "
              f"2x2 ranks, {backend}, steps {HYDRO_CHECK[0]}.."
              f"{HYDRO_CHECK[1] - 1}: radiation every 12; synchronised, "
              f"slowest rank): "
              f"{res[0]['hydro']['ms_per_step']:.3f}, one card "
              f"{icbc13['window_ms']:.3f} (phase 13a, the same steps), on "
              f"{smi}")
        # -- 14c. the NH flagship on 2x2 ranks against phase 14a
        for r, out in enumerate(res):
            h = out["nh"]
            print(f"  rank {r} NH flagship: launches {h['launches']}, "
                  f"{h['exchanges_per_step']:.1f} halo exchanges and "
                  f"{h['bytes_per_step'] / 1e6:.3f} MB sent a step")
            if not h["finite"]:
                raise AssertionError(f"rank {r}: non-finite decomposed NH "
                                     f"state")
            if h["launches"]["K5c"] <= 0 or h["launches"]["K2"] <= 0 \
                    or h["launches"]["K1"] != 0:
                raise AssertionError(f"rank {r} ({backend}): the "
                                     f"decomposed NH path bypassed K5c or "
                                     f"K2: {h['launches']}")
        dec = res[0]["nh"]["dec"]
        for f in NH_FIELDS:
            same = np.array_equal(dec[f], nh12[f])
            err = rel_rms(dec[f], nh12[f])
            print(f"  NH 192x192x41 f32 step {DECOMP_STEPS}, {backend} 2x2 "
                  f"vs one card, {f}: "
                  f"{'bit-identical' if same else 'DIFFERENT'}, rel-RMS "
                  f"{err:.3e}")
            if not same:
                raise AssertionError(f"decomposed NH flagship ({backend}) "
                                     f"differs from one card in {f}: "
                                     f"rel-RMS {err}")
        print(f"  decomposed NH ms/step (f32, 192x192x41 dt {NH_DT} s on "
              f"2x2 ranks, {backend}, steps {TIME_START}.."
              f"{TIME_START + TIME_STEPS - 1}: cumulus at 20; "
              f"synchronised, slowest rank): "
              f"{res[0]['nh']['ms_per_step']:.3f} on {smi}")
        # -- 15e. configuration A on 2x2 ranks against phase 15a
        for r, out in enumerate(res):
            h = out["schemes"]
            print(f"  rank {r} configuration A: launches {h['launches']}")
            if not h["finite"]:
                raise AssertionError(f"rank {r}: non-finite decomposed "
                                     f"configuration A")
            if h["launches"]["K2"] <= 0:
                raise AssertionError(f"rank {r} ({backend}): the "
                                     f"decomposed configuration A "
                                     f"bypassed K2: {h['launches']}")
        dec = res[0]["schemes"]["dec"]
        n = HYDRO_CHECK[0]
        for f in HYDRO_FIELDS:
            same = np.array_equal(dec[f], a15[n][f])
            print(f"  configuration A f32 step {n}, {backend} 2x2 vs one "
                  f"card (15a), {f}: "
                  f"{'bit-identical' if same else 'DIFFERENT'}, rel-RMS "
                  f"{rel_rms(dec[f], a15[n][f]):.3e}")
            if not same:
                raise AssertionError(f"decomposed configuration A "
                                     f"({backend}) differs from one card in "
                                     f"{f} at step {n}")
        # -- 16d. configuration C on 2x2 ranks against one card
        for r, out in enumerate(res):
            h = out["cumulus"]
            print(f"  rank {r} configuration C: launches {h['launches']}")
            if not h["finite"]:
                raise AssertionError(f"rank {r}: non-finite decomposed "
                                     f"configuration C")
            if h["launches"]["K5c"] <= 0 or h["launches"]["K2"] <= 0 \
                    or h["launches"]["K1"] != 0:
                raise AssertionError(f"rank {r} ({backend}): the "
                                     f"decomposed configuration C bypassed "
                                     f"K5c or K2: {h['launches']}")
        dec = res[0]["cumulus"]["dec"]
        n = HYDRO_CHECK[0]
        for f in HYDRO_FIELDS:
            same = np.array_equal(dec[f], c16[f])
            print(f"  configuration C f32 step {n}, {backend} 2x2 vs one "
                  f"card (16d), {f}: "
                  f"{'bit-identical' if same else 'DIFFERENT'}, rel-RMS "
                  f"{rel_rms(dec[f], c16[f]):.3e}")
            if not same:
                raise AssertionError(f"decomposed configuration C "
                                     f"({backend}) differs from one card in "
                                     f"{f} at step {n}")
        # -- 17b. configuration D and the CRM on 2x2 ranks
        check_band_decomposed(res, backend, d17, crm_ref)
        # -- 18b, 18d. the semi-Lagrangian advection on 2x2 ranks
        check_sl_decomposed(res, backend, sl_ref)
        # -- 19e. the chemistry on 2x2 ranks
        check_chem_decomposed(res, backend, e19)
        # -- 20d. the gas phase on 2x2 ranks
        check_gas_decomposed(res, backend, g20)
        decomp[backend] = res
    return decomp


def nh_flagship_cfg(n=None):
    """The flagship's widths on the MM5 NH core: n x n x 41 (n FLAGSHIP
    by default), ds 3 km, dt NH_DT, flat, default physics."""
    cfg = flagship_cfg()
    cfg.core.idynamic = 2
    if n is not None:
        cfg.dim.iy = cfg.dim.jx = n
    cfg.time.dt = NH_DT
    return cfg


def nh_model(cfg, grid, device, mesh=None):
    """Model on the NH flagship's settings in f32 from the whole grid's
    nh_initial_state(perturb=0.5, seed=1), formed on the host (the rank's
    block under a mesh)."""
    import torch
    from regcm_tpu_torch.driver import Model, nh_initial_state
    s0 = nh_initial_state(grid, cfg, "cpu", torch.float32, perturb=0.5,
                          seed=1)
    return Model(cfg, grid=grid, device=device, dtype=torch.float32,
                 initial_state=s0, mesh=mesh)


def nh_fields(model):
    """The decoupled fields of a NH Model with pp and w, of the whole
    domain (gathered under a mesh)."""
    d = model.decoupled()
    s = model.state
    extra = dict(pp=s.pp_a / s.ps_a[None], w=s.w_a / s.ps_a[None])
    if model.mesh is not None:
        extra = {k: model.mesh.gather(v) for k, v in extra.items()}
    d.update({k: v.cpu().numpy() for k, v in extra.items()})
    return d


def nh_summary(d):
    """(max |w| m/s, max |pp| Pa, T min K, T max K) of nh_fields."""
    return (float(np.abs(d["w"]).max()), float(np.abs(d["pp"]).max()),
            float(d["t"].min()), float(d["t"].max()))


def run_nh_single(dev, smi, mods, chain=None):
    """Phase 14a: the NH flagship on one card; returns its step-12
    fields (14c is held to them) and its launches a step. Phase 18a's
    NH ``chain`` rides on its first 24 steps."""
    import torch
    from regcm_tpu_torch.core.grid import build_grid
    cfg = nh_flagship_cfg()
    grid = build_grid(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    model = nh_model(cfg, grid, dev)
    torch.cuda.synchronize()
    print(f"NH model: {grid.jx}x{grid.iy}x{grid.kz}, dt {cfg.dtsec} s, ds "
          f"{cfg.geo.ds} km, set-up {time.time() - t0:.1f} s")
    reset(mods)
    model.run(DECOMP_STEPS)
    single12 = nh_fields(model)
    if chain is not None:
        chain(model)
    model.run(STEPS - DECOMP_STEPS)
    launches = read(mods)
    if chain is not None:
        chain(model)
    print(f"NH path: {STEPS} steps, launches {launches}")
    if not model.check_finite():
        raise AssertionError("non-finite NH state after the f32 run")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"NH path bypassed a kernel: {launches}")
    wmax, ppmax, tmin, tmax = nh_summary(nh_fields(model))
    print(f"NH step {STEPS}: wmax {wmax:.4f} m/s, ppmax {ppmax:.3f} Pa, "
          f"T {tmin:.3f}..{tmax:.3f} K")
    _, wall = model.run(STEPS)
    print(f"NH ms/step (f32, {grid.jx}x{grid.iy}x{grid.kz}, dt {NH_DT} s, "
          f"steps {STEPS}..{2 * STEPS - 1}: cumulus and surface at 40, no "
          f"radiation; synchronised): {1000.0 * wall / STEPS:.3f} on {smi}")
    profile_steps(model, 4, "NH")
    rad = int(round(cfg.time.dtrad_sec / cfg.dtsec))
    while model.nstep < rad and model.check_finite():
        model.run(1)
    if not model.check_finite():
        raise AssertionError(f"non-finite NH state after step "
                             f"{model.nstep}, before the radiation step")
    if not model._flags().do_rad:
        raise AssertionError(f"no radiation alarm at step {rad}")
    _, wall = model.run(1)
    print(f"NH radiation step (step {rad}: radiation, surface, cumulus; "
          f"synchronised): {1000.0 * wall:.3f} ms on {smi}")
    print(f"NH peak device memory (steps 0..{model.nstep}): "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    if not model.check_finite():
        raise AssertionError(f"non-finite NH state after the radiation "
                             f"step {rad}")
    wmax, ppmax, tmin, tmax = nh_summary(nh_fields(model))
    print(f"NH {grid.jx}x{grid.iy}x{grid.kz} f32 finite through step "
          f"{model.nstep}: wmax {wmax:.4f} m/s, ppmax {ppmax:.3f} Pa, T "
          f"{tmin:.3f}..{tmax:.3f} K")
    del model
    torch.cuda.empty_cache()

    # -- the same settings on a 48x48 cut, held to the JAX package's
    # numbers (tools/nh_3km_reference.py): 1% of wmax and ppmax, 0.05 K
    rcfg = nh_flagship_cfg(48)
    model = nh_model(rcfg, build_grid(rcfg), dev)
    for n in range(1, max(NH_REFERENCE) + 1):
        model.run(1)
        if n in NH_REFERENCE:
            got = nh_summary(nh_fields(model))
            want = NH_REFERENCE[n]
            print(f"NH 48x48x41 f32 step {n}: wmax {got[0]:.5f} m/s, ppmax "
                  f"{got[1]:.4f} Pa, T {got[2]:.4f}..{got[3]:.4f} K; JAX "
                  f"package {want[0]:.5f}, {want[1]:.4f}, "
                  f"{want[2]:.4f}..{want[3]:.4f}")
            if not (abs(got[0] - want[0]) < 0.01 * want[0]
                    and abs(got[1] - want[1]) < 0.01 * want[1]
                    and abs(got[2] - want[2]) < 0.05
                    and abs(got[3] - want[3]) < 0.05):
                raise AssertionError(f"NH step {n} on the card leaves the "
                                     f"reference: {got}")
    del model
    torch.cuda.empty_cache()
    return dict(single12=single12,
                per_step={k: v / STEPS for k, v in launches.items()})


def nh_card_vs_cpu(dev, cpu):
    """Phase 14b: NH on the card against the CPU in f64, 16x20x14 over
    phase 7's hill (ds 10 km, dt 30 s), 10 steps: full physics held to
    four times the CPU's spread (or 1e-7), the dynamics alone (no
    saturation adjustment) to 1e-7, by card_vs_cpu; ``cpu`` the futures
    of nh_check_run's CPU runs."""
    check_run_vs_cpu(dev, nh_check_run, cpu, NH_FIELDS, "NH")


def option_run(option, device):
    """Phase 14d: three f64 dynamics steps with one option, 18x24x14
    over the hill: the hydrostatic core (ds 60 km, dt 120 s) from the
    0.2 K perturbed standard atmosphere with a 10 m/s westerly, or the
    NH core (ds 10 km, dt 30 s) from nh_initial_state(perturb=0.3); the
    state's prognostics."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.core.state import StepFlags, bdy_from_state
    from regcm_tpu_torch.driver import (nh_initial_state,
                                        standard_atmosphere_state)
    from regcm_tpu_torch.dynamics.hydrostatic import HydroCore
    from regcm_tpu_torch.dynamics.stencil import cross2dot
    core_kind, opts = OPTIONS[option]
    cfg = RegCMConfig()
    cfg.core.idynamic = core_kind
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 18, 24, 14
    cfg.geo.ds, cfg.time.dt = (60.0, 120.0) if core_kind == 1 \
        else (10.0, 30.0)
    cfg.physics.ipptls = 0
    for k, v in opts.items():
        if k == "ithadv":
            cfg.dyn.extras[k] = v
        else:
            setattr(cfg.physics, k, v)
    grid = build_grid(cfg, ht=hill(18, 24))
    f64 = torch.float64
    if core_kind == 1:
        s = standard_atmosphere_state(grid, cfg, "cpu", f64, perturb=0.2,
                                      seed=3)
        u = 10.0 * cross2dot(s.ps_a)[None] * torch.ones_like(s.u_a)
        qx = torch.cat([torch.maximum(s.qx_a[0], 1e-5 * s.ps_a[None])[None],
                        s.qx_a[1:]])
        s = s._replace(u_a=u, u_b=u, qx_a=qx, qx_b=qx)
    else:
        s = nh_initial_state(grid, cfg, "cpu", f64, perturb=0.3, seed=1)
    core = HydroCore(grid, cfg, device=device, dtype=f64)
    s = s._replace(**{k: v.to(device) for k, v in s._asdict().items()})
    if core_kind == 1:
        s = core.init_split_storage(s)
    step = core.step if core_kind == 1 else core.step_nh
    bdy = bdy_from_state(s)
    xt, dt = 0.0, cfg.dtsec
    for _ in range(3):
        s, _ = step(s, bdy, xt, dt, StepFlags())
        xt += cfg.dtsec
        dt = 2.0 * cfg.dtsec
    names = ("u_a", "v_a", "t_a", "qx_a") + (("pp_a", "w_a")
                                             if core_kind == 2 else ())
    return {k: getattr(s, k).cpu().numpy() for k in names}


def options_card_vs_cpu(dev, cpus):
    """Phase 14d: each option on the card against the CPU, max relative
    error of every prognostic below 1e-10; ``cpus`` the futures of the
    CPU runs by option."""
    for option in OPTIONS:
        gpu, cpu = option_run(option, dev), cpus[option].result()
        worst = max((max_rel(gpu[k], w), k) for k, w in cpu.items())
        print(f"option {option}: 3 steps f64 18x24x14, card vs CPU worst "
              f"{worst[1]} max rel err {worst[0]:.3e} (bound 1e-10)")
        if not worst[0] <= 1e-10 or not all(
                np.all(np.isfinite(v)) for v in gpu.values()):
            raise AssertionError(f"option {option}: card and CPU disagree "
                                 f"in {worst[1]}: {worst[0]}")


def max_rel(got, want):
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


# -- phase 15: the second physics set -----------------------------------
def with_physics(cfg, physics):
    for k, v in physics.items():
        setattr(cfg.physics, k, v)
    return cfg


def moisten(s, idynamic, qvfac=1.8):
    """Phase 15c's start: qv ``qvfac`` times the rest state's (1.8: about
    90% of saturation), cloud water between 250 K and 290 K and ice
    between 220 K and 265 K where the state carries them (qv and qc alone
    under SUBEX), so that the microphysics has work from step 0."""
    import torch
    if idynamic == 3:
        cpl, t, qx0 = 1.0, s.t, s.qx
    else:
        cpl = s.ps_a[None]
        t, qx0 = s.t_a / cpl, s.qx_a
    qv = qvfac * qx0[0] / cpl
    qc = torch.where((t > 250.0) & (t < 290.0), t.new_tensor(1.0e-4), 0.0)
    qi = torch.where((t > 220.0) & (t < 265.0), t.new_tensor(3.0e-5), 0.0)
    z = torch.zeros_like(qv)
    qx = torch.stack([qv, qc, z, qi, z][:qx0.shape[0]]) * cpl
    if idynamic == 3:
        return s._replace(qx=qx)
    return s._replace(qx_a=qx, qx_b=qx.clone())


def step_kernels(model, step):
    """One ``step`` call under torch.profiler: (device kernels launched,
    device busy ms, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        wall = 1e3 * (time.time() - t0)
    kern = device_events(prof)
    return len(kern), sum(ms for _, ms in kern), wall


def run_schemes_a(dev, smi, paths, mods):
    """Phase 15a: configuration A (test_001 from phase 13's ICBC files,
    f32) for A_STEPS steps; returns its step-12 fields (15e holds the 2x2
    run to them), its launches a step and the kernel count of a cumulus
    step."""
    import torch
    model = hydro_icbc_model(paths, dev, physics=SCHEME_A)
    land = float(np.mean(model.grid.lndocn))
    print(f"15a. configuration A {SCHEME_A} on test_001 "
          f"({model.grid.jx}x{model.grid.iy}x{model.grid.kz}, f32, from "
          f"ICBC): land fraction {land:.3f}")
    if not 0.0 < land < 1.0:
        raise AssertionError("configuration A's domain has no land/water "
                             "split: one cumulus scheme would never run")
    reset(mods)
    rows, rec = [], {}
    while model.nstep < A_STEPS:
        f = model._flags()
        _, wall = model.run_icbc(1)
        kind = "radiation" if f.do_rad else "cumulus" if f.do_cum \
            else "plain"
        rows.append((model.nstep - 1, kind, 1000.0 * wall))
        if model.nstep in HYDRO_CHECK:
            rec[model.nstep] = model.decoupled()
    launches = read(mods)
    ncum = sum(1 for n, k, _ in rows if k != "plain")
    print(f"15a path: {A_STEPS} steps, launches {launches} "
          f"({ncum} cumulus steps: K2 {launches['K2'] / ncum:.2f} a "
          f"cumulus step)")
    if not model.check_finite():
        raise AssertionError("15a: non-finite state")
    if launches["K2"] <= 0 or launches["K1"] != 0:
        raise AssertionError(f"15a bypassed K2 (Emanuel over land) or ran "
                             f"Holtslag's K1 under the UW TCM: {launches}")
    d = model.decoupled()
    qx = model.state.qx_a / model.state.ps_a[None]
    print(f"15a step {A_STEPS}: ps {d['ps'].min():.3f}.."
          f"{d['ps'].max():.3f} hPa, T {d['t'].min():.3f}.."
          f"{d['t'].max():.3f} K, max qc/qr/qi/qs "
          + "/".join(f"{float(qx[i].max()):.3e}" for i in range(1, 5))
          + f", max TKE {float(model.state.tke_a.max()):.3f} m2/s2, "
          f"rainc+rainnc max "
          f"{float((model.state.rainc + model.state.rainnc).max()):.3f} mm")
    ms = {}
    for kind in ("plain", "cumulus", "radiation"):
        t = [w for n, k, w in rows if k == kind and n >= 1]
        ms[kind] = sum(t) / len(t)
        print(f"15a ms/step (f32, 34x48x18, steps 1..{A_STEPS - 1}, each "
              f"synchronised), {kind} steps: {ms[kind]:.3f} over {len(t)} "
              f"steps, on {smi}")
    next_cumulus_step(model)
    nker, busy, wall = step_kernels(model, lambda: model.run_icbc(1))
    print(f"15a cumulus step {model.nstep - 1} under the profiler: {nker} "
          f"device kernels, device busy {busy:.2f} ms of {wall:.1f} ms wall")
    del model
    torch.cuda.empty_cache()
    return dict(rec=rec, ms=ms, cum_kernels=nker,
                per_step={k: v / A_STEPS for k, v in launches.items()})


def schemes_b_cfg(n=FLAGSHIP):
    cfg = flagship_cfg()
    cfg.dim.iy = cfg.dim.jx = n
    return with_physics(cfg, SCHEME_B)


def run_schemes_b(dev, smi, mods):
    """Phase 15b: configuration B on MOLOCH at the flagship's widths, f32:
    24 steps through K1, K3 and K4 (nf = 10) with the counters checked,
    the ms/step of steps 24-47, the peak memory and the first
    non-finite step; then the 48x48x41 cut held to B_REFERENCE. Both
    from the flagship's perturbed rest state moistened by ``moisten``."""
    import torch
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    cfg = schemes_b_cfg()
    grid = build_grid(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    s0 = moisten(MolochCore(grid, cfg, device=dev, dtype=torch.float32
                            ).initial_state(perturb=0.3, seed=1), 3)
    model = Model(cfg, grid=grid, device=dev, dtype=torch.float32,
                  initial_state=s0)
    del s0
    print(f"15b. configuration B {SCHEME_B} on MOLOCH "
          f"{grid.jx}x{grid.iy}x{grid.kz}, f32, nqx {model.core.nqx}")
    reset(mods)
    walls, bad, launches = [], None, None
    for n in range(2 * B_STEPS):
        if n == B_STEPS:
            launches = read(mods)
        _, wall = model.run(1)
        walls.append(1000.0 * wall)
        if bad is None and not model.check_finite():
            bad = model.nstep
            break
    if launches is None:
        launches = read(mods)
    print(f"15b path: {B_STEPS} steps, launches {launches}")
    if min(launches[k] for k in ("K1", "K3", "K4")) <= 0 \
            or launches["K2"] != 0:
        raise AssertionError(f"15b bypassed a kernel or ran Emanuel's K2 "
                             f"with the cumulus off: {launches}")
    print(f"15b MOLOCH 192x192x41 f32 with configuration B: "
          + (f"non-finite after step {bad}" if bad is not None
             else f"finite through step {model.nstep}"))
    if bad is not None and bad <= B_STEPS:
        raise AssertionError(f"15b: non-finite within {B_STEPS} steps")
    timed = walls[B_STEPS:]
    if bad is None:
        print(f"15b ms/step (f32, 192x192x41, steps {B_STEPS}.."
              f"{2 * B_STEPS - 1}: cumulus off, surface at 40, no "
              f"radiation; each synchronised): "
              f"{sum(timed) / len(timed):.3f} on {smi}; peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
        nker, busy, wall = step_kernels(model, lambda: model.run(1))
        print(f"15b step {model.nstep - 1} under the profiler: {nker} "
              f"device kernels, device busy {busy:.2f} ms of {wall:.1f} ms "
              f"wall")
    del model
    torch.cuda.empty_cache()
    # the 48x48x41 cut against the JAX package's numbers
    cfg = schemes_b_cfg(48)
    grid = build_grid(cfg)
    model = Model(cfg, grid=grid, device=dev, dtype=torch.float32,
                  initial_state=moisten(MolochCore(
                      grid, cfg, device=dev, dtype=torch.float32
                  ).initial_state(perturb=0.3, seed=1), 3))
    for n in range(1, max(B_REFERENCE) + 1):
        model.run(1)
        if n in B_REFERENCE:
            d = model.decoupled()
            qx = model.state.qx
            got = (float(d["ps"].min()), float(d["ps"].max()),
                   float(np.abs(d["w"]).max())) + tuple(
                       float(qx[i].max()) for i in range(1, 5))
            want = B_REFERENCE[n]
            print(f"15b 48x48x41 f32 step {n}: ps {got[0]:.4f}..{got[1]:.4f}"
                  f" hPa, wmax {got[2]:.5f} m/s, max qc/qr/qi/qs "
                  + "/".join(f"{g:.4e}" for g in got[3:])
                  + f"; JAX package {want[0]:.4f}..{want[1]:.4f} hPa, "
                  f"{want[2]:.5f} m/s, "
                  + "/".join(f"{w:.4e}" for w in want[3:]))
            # ps, w as phase 6b; qc and qi within 1% (qr and qs, still
            # ~1e-9 and below, are printed)
            ok = (abs(got[0] - want[0]) < 0.1 and abs(got[1] - want[1]) < 0.1
                  and abs(got[2] - want[2]) < 0.01 * want[2]
                  and all(abs(got[i] - want[i]) <= 0.01 * want[i]
                          for i in (3, 5)))
            if not ok:
                raise AssertionError(f"15b step {n} on the card leaves the "
                                     f"reference: {got}")
    del model
    torch.cuda.empty_cache()
    return dict(per_step={k: v / B_STEPS for k, v in launches.items()},
                ms=sum(timed) / len(timed) if bad is None else None)


def scheme_cases():
    """Phase 15c's cases: (name, idynamic, ds, dt, physics overrides,
    steps) on 16x20x14 over the 500 m hill with water."""
    out = [("A hydrostatic", 1, 50.0, 150.0, SCHEME_A, 3),
           ("A NH", 2, 10.0, 30.0, SCHEME_A, 3),
           ("B MOLOCH", 3, 3.0, 30.0, SCHEME_B, 3)]
    for i in range(1, 7):
        out.append((f"A icldfrac={i}", 1, 50.0, 150.0,
                    dict(SCHEME_A, icldfrac=i), 1))
    return out


def scheme_run(i, device, perturbed=False):
    """Phase 15c's run of case ``i`` of scheme_cases in f64 on ``device``
    from the moistened start (cumulus every step, every alarm at step 0;
    ``perturbed``: T changed by 1e-15): the decoupled fields and the
    hydrometeors."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import (Model, nh_initial_state,
                                        standard_atmosphere_state)
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.preproc.terrain import synthetic_topo
    name, idyn, ds, dt, phys, steps = scheme_cases()[i]
    cfg = with_physics(RegCMConfig(), phys)
    cfg.core.idynamic = idyn
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 20, 14
    cfg.geo.ds, cfg.time.dt, cfg.time.dtcum = ds, dt, dt
    topo, _, mask = synthetic_topo(cfg, kind="gauss", height=500.0)
    grid = build_grid(cfg, ht=topo, landmask=mask)
    if idyn == 3:
        s0 = MolochCore(grid, cfg, device="cpu").initial_state(
            perturb=0.3, seed=1)
    else:
        start = nh_initial_state if idyn == 2 \
            else standard_atmosphere_state
        s0 = start(grid, cfg, "cpu", perturb=0.3, seed=1)
    s0 = moisten(s0, idyn)
    if perturbed:
        s0 = perturb_t(s0, "t" if idyn == 3 else "t_a")
    m = Model(cfg, grid=grid, device=device, dtype=torch.float64,
              initial_state=s0)
    m.run(steps)
    if not m.check_finite():
        raise AssertionError(f"15c {name}: non-finite on {device} "
                             f"(perturbed {perturbed})")
    d = m.decoupled()
    qx = m.state.qx if idyn == 3 else m.state.qx_a / m.state.ps_a[None]
    for j, q in enumerate(("qc", "qr", "qi", "qs"), 1):
        d[q] = qx[j].cpu().numpy()
    return d


def schemes_card_vs_cpu(dev, cpu):
    """Phase 15c: each case on the card against the CPU in f64 from the
    same moistened start (cumulus every step, every alarm at step 0):
    rel-RMS below max(1e-7, 4 x the CPU run's spread under a 1e-15
    relative change of T); a hydrometeor beyond it only at the points
    where a microphysics threshold flipped (at most 1% of them).
    ``cpu``: each case's futures of its CPU runs."""
    for i, case in enumerate(scheme_cases()):
        name, steps = case[0], case[5]
        runs = dict(gpu=scheme_run(i, dev))
        runs.update(results(cpu[i]))
        worst, flips = (0.0, ""), {}
        for f in ("ps", "t", "qv", "u", "v", "qc", "qr", "qi", "qs"):
            want = runs["cpu"][f]
            err = rel_rms(runs["gpu"][f], want)
            lim = max(1e-7, 4.0 * rel_rms(runs["cpu_perturbed"][f], want))
            worst = max(worst, (err / lim, f))
            if err < lim:
                continue
            off = np.abs(runs["gpu"][f] - want) > 1e-7 * np.abs(want).max()
            flips[f] = int(off.sum())
            if f in ("ps", "t", "qv", "u", "v") or off.mean() > 0.01:
                raise AssertionError(f"15c {name}: card and CPU disagree "
                                     f"on {f}: rel-RMS {err} (bound {lim})")
        print(f"15c {name}, {steps} steps f64, card vs CPU: worst field "
              f"{worst[1]} at {worst[0]:.3f} of its bound"
              + (f"; points past 1e-7 by a branch flip {flips}" if flips
                 else ""))


def compare_nf10(dev, k4):
    """Phase 15d: K4 and K5a at B's stack of nf = 10 fields (θv, π, ux,
    vx, wx and five water species) at 192x192x41: each against its plain
    version (f64 1e-12, f32 1e-5), the 2x2 blocks of K5a against K4 bit
    for bit, with the time and bound of each (f32)."""
    import torch
    from regcm_tpu_torch.parallel.halo import extend_block
    from regcm_tpu_torch.parallel.mesh import DomainMesh
    shape = (NF10,) + tuple(SHAPES["K4"][1][1:])
    modes = ["zero"] * 4 + ["edge"] * 2 + ["zero"] * 2
    stats = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        args = k4_inputs(shape, dtype, dev)
        ops, (dtrdx, dtrdz) = args[:8], args[8:]
        iy, jx = shape[-2:]
        want = k4.waf_advect(*args)
        plain = k4.waf_advect_plain(*args)
        torch.cuda.synchronize()
        rel, ab = rel_err(want, plain)
        print(f"15d K4 {dname} {shape}: max rel err {rel:.3e} against the "
              f"plain version (max abs {ab:.3e}, tol {TOL[dname]['K4']:g})")
        if not rel <= TOL[dname]["K4"]:
            raise AssertionError(f"15d K4 {dname} nf=10 disagrees: {rel}")
        meshes = [DomainMesh(*GRID, iy, jx, rank=r)
                  for r in range(GRID[0] * GRID[1])]
        blocks = []
        for m in meshes:
            ext = [extend_block(a, m.y0, m.x0, m.ly, m.lx, 2, mode)
                   for a, mode in zip(ops, modes)]
            geo = (dtrdx, dtrdz, iy, jx, m.y0, m.x0)
            blocks.append((lambda ext=ext, geo=geo:
                           k4.waf_advect_halo(*ext, *geo),
                           lambda ext=ext, geo=geo:
                           k4.waf_advect_sharded_plain(*ext, *geo)))
        cat = lambda bl: torch.cat([torch.cat(bl[py * GRID[1]:(py + 1)
                                                 * GRID[1]], dim=-1)
                                    for py in range(GRID[0])], dim=-2)
        got = cat([kern() for kern, _ in blocks])
        ref = cat([pl() for _, pl in blocks])
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        rel5, ab5 = rel_err(got, ref)
        print(f"15d K5a {dname} 2x2 blocks of {shape}: "
              f"{'bit-identical' if same else 'DIFFERENT'} to K4; against "
              f"the plain version max rel err {rel5:.3e} (max abs "
              f"{ab5:.3e})")
        if not same:
            raise AssertionError(f"15d K5a {dname} nf=10 differs from K4 by "
                                 f"{float((got - want).abs().max())}")
        if not rel5 <= TOL[dname]["K4"]:
            raise AssertionError(f"15d K5a {dname} nf=10 disagrees with "
                                 f"its plain version: {rel5}")
        if dname == "float32":
            bshape = shape[:2] + (meshes[0].ly, meshes[0].lx)
            for k, kern, pl, shp, err in (
                    ("K4", lambda: k4.waf_advect(*args),
                     lambda: k4.waf_advect_plain(*args), shape, ab),
                    ("K5a", blocks[0][0], blocks[0][1], bshape, ab5)):
                b_ms, b_by, byt, nops = bound(k, shp, 4)
                st = dict(max_abs_err=err, ms=time_ms(kern),
                          device_ms=device_ms(kern, KERNELS["K4"]),
                          plain_ms=time_ms(pl), bound_ms=b_ms,
                          bound_by=b_by, shape=list(shp))
                stats[k] = st
                print(f"15d {k} f32 {tuple(shp)}: kernel {st['ms']:.4f} ms "
                      f"(device {st['device_ms']:.4f} ms), plain "
                      f"{st['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}: {byt / 1e6:.1f} MB, {nops / 1e9:.3f} "
                      f"GFLOP)")
        del args, ops, want, plain, got, ref, blocks
        torch.cuda.empty_cache()
    return stats


def schemes_rank(rank, paths):
    """Phase 15e on one rank of the 2x2 group: configuration A from the
    ICBC files for HYDRO_CHECK[0] steps (counters reset just before,
    read just after); the whole domain's fields (on rank 0)."""
    import torch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    mods = {"K1": k1, "K2": k2}
    model = hydro_icbc_model(paths, rank.device, rank.mesh(34, 48),
                             physics=SCHEME_A)
    reset(mods)
    k1.launches_sharded = 0
    model.run_icbc(HYDRO_CHECK[0])
    launches = read(mods)
    launches["K5c"] = k1.launches_sharded
    out = dict(launches=launches, finite=model.check_finite())
    dec = model.decoupled()
    out["dec"] = dec if rank.rank == 0 else None
    del model
    torch.cuda.empty_cache()
    return out


# -- phase 16: the remaining cumulus schemes -----------------------------
def eur44_cfg():
    """Configuration C at the EUR-44 extent over phase 13's one-day ICBC
    window."""
    from regcm_tpu_torch.config.params import RegCMConfig
    cfg = with_physics(RegCMConfig(), SCHEME_C)
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = EUR44
    cfg.globdat.gdate2 = ICBC_END
    return cfg


def write_eur44_files(directory):
    """16a's input files, written by the port's preprocessors: the EUR-44
    DOMAIN file of a 500 m hill whose lower 40% is water, and its one-day
    ICBC file with a 10 m/s jet."""
    from regcm_tpu_torch.preproc.icbc import generate_synthetic_icbc
    from regcm_tpu_torch.preproc.terrain import synthetic_topo, write_domain
    cfg = eur44_cfg()
    topo, lnd, mask = synthetic_topo(cfg, kind="gauss", height=500.0)
    paths = dict(domain=os.path.join(directory, "eur44_DOMAIN000.nc"),
                 hydro=os.path.join(directory, "eur44_ICBC.nc"))
    write_domain(cfg, paths["domain"], topo, lnd, mask)
    generate_synthetic_icbc(cfg, topo, paths["hydro"], jet=10.0)
    return paths


def step_kind(flags):
    """The alarm class of a step: radiation, surface (at test_001's
    alarms always with the cumulus), cumulus or plain; a step of several
    alarms counts as the costliest."""
    return ("radiation" if flags.do_rad else "surface" if flags.do_srf
            else "cumulus" if flags.do_cum else "plain")


def timed_steps(model, until, record=()):
    """run_icbc one step at a time up to step ``until``: (step, alarm
    class, wall ms synchronised, cumulus alarm) of each, and the
    decoupled fields after the steps in ``record``."""
    rows, rec = [], {}
    while model.nstep < until:
        f = model._flags()
        _, wall = model.run_icbc(1)
        rows.append((model.nstep - 1, step_kind(f), 1000.0 * wall,
                     f.do_cum))
        if model.nstep in record:
            rec[model.nstep] = model.decoupled()
    return rows, rec


def class_ms(rows, what, smi, shape, first=1):
    """Print and return the mean ms/step of each alarm class from step
    ``first`` on (step 0 pays the first calls' set-up)."""
    ms = {}
    for kind in ("plain", "cumulus", "surface", "radiation"):
        t = [w for n, k, w, _ in rows if k == kind and n >= first]
        ms[kind] = sum(t) / len(t) if t else None
        print(f"{what} ms/step (f32, {shape}, steps {first}.."
              f"{rows[-1][0]}, each synchronised), {kind} steps: "
              + (f"{ms[kind]:.3f} over {len(t)} steps" if t
                 else "none in these steps")
              + f", on {smi}")
    return ms


def next_cumulus_step(model):
    """Run up to the next step of the cumulus class (the cumulus alarm
    alone)."""
    while step_kind(model._flags()) != "cumulus":
        model.run_icbc(1)


def run_config_c(dev, smi, paths, mods):
    """Phase 16a: configuration C at the EUR-44 extent from its own DOMAIN
    and ICBC files through step 150."""
    import torch
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    cfg = eur44_cfg()
    grid = build_grid_from_domain(cfg, paths["domain"])
    t0 = time.time()
    model = Model(cfg, grid=grid, device=dev, dtype=torch.float32)
    model.init_from_icbc(ICBCReader(paths["hydro"], cfg.globdat.calendar))
    torch.cuda.synchronize()
    # the peak from here on holds the state and every step's temporaries
    torch.cuda.reset_peak_memory_stats(dev)
    land = float(np.mean(grid.lndocn))
    shape = f"{grid.jx}x{grid.iy}x{grid.kz}"
    print(f"16a. configuration C {SCHEME_C} at the EUR-44 extent {shape} "
          f"(ds {cfg.geo.ds} km, dt {cfg.dtsec} s, f32, from ICBC; set-up "
          f"{time.time() - t0:.1f} s): land fraction {land:.3f}")
    if not 0.05 <= land <= 0.95:
        raise AssertionError("16a: the domain needs 5% each of land and "
                             "water, so that Grell and Emanuel both run")
    reset(mods)
    rows, rec = timed_steps(model, HYDRO_ICBC_STEPS, (HYDRO_ICBC_STEPS,))
    launches = read(mods)
    ncum = sum(1 for row in rows if row[3])
    print(f"16a path: {HYDRO_ICBC_STEPS} steps, launches {launches} "
          f"(K1 {launches['K1'] / HYDRO_ICBC_STEPS:.2f} a step, K2 "
          f"{launches['K2'] / ncum:.2f} a cumulus step), boundary clock "
          f"{model.xbctime:.0f} s after the update at step 144")
    if not model.check_finite():
        raise AssertionError("16a: non-finite state")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"16a bypassed K1 (Holtslag) or K2 (Emanuel "
                             f"over water): {launches}")
    if model.xbctime >= 6 * 3600.0:
        raise AssertionError("16a: no boundary update")
    d = rec[HYDRO_ICBC_STEPS]
    print(f"16a step {HYDRO_ICBC_STEPS}: ps {d['ps'].min():.3f}.."
          f"{d['ps'].max():.3f} hPa, T {d['t'].min():.3f}.."
          f"{d['t'].max():.3f} K, rainc max "
          f"{float(model.state.rainc.max()):.4f} mm, rainnc max "
          f"{float(model.state.rainnc.max()):.4f} mm")
    ms = class_ms(rows, "16a", smi, shape)
    next_cumulus_step(model)
    nker, busy, wall = step_kernels(model, lambda: model.run_icbc(1))
    print(f"16a cumulus step {model.nstep - 1} under the profiler: {nker} "
          f"device kernels, device busy {busy:.2f} ms of {wall:.1f} ms wall "
          f"({100.0 * busy / wall:.1f}%)")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"16a peak device memory {peak:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    return dict(ms=ms, cum_kernels=nker, land=land, peak_gib=peak,
                per_step={k: v / HYDRO_ICBC_STEPS
                          for k, v in launches.items()})


def run_cumulus_schemes(dev, smi, paths, mods):
    """Phase 16b: Kuo, Betts-Miller with shallow convection and
    Kain-Fritsch on test_001 from phase 13's ICBC files, CU_STEPS steps
    each; then configuration C there for HYDRO_CHECK[0] steps, the
    single card 16d holds its 2x2 run to."""
    import torch
    out = {}
    for name, phys in CU_SCHEMES.items():
        model = hydro_icbc_model(paths, dev, physics=phys)
        reset(mods)
        rows, _ = timed_steps(model, CU_STEPS)
        launches = read(mods)
        print(f"16b {name} {phys} on test_001 from ICBC: {CU_STEPS} steps, "
              f"launches {launches}")
        if not model.check_finite():
            raise AssertionError(f"16b {name}: non-finite state")
        if launches["K1"] <= 0:
            raise AssertionError(f"16b {name} bypassed K1: {launches}")
        ms = class_ms(rows, f"16b {name}", smi, "34x48x18")
        next_cumulus_step(model)
        nker, busy, wall = step_kernels(model, lambda: model.run_icbc(1))
        print(f"16b {name} cumulus step {model.nstep - 1} under the "
              f"profiler: {nker} device kernels, device busy {busy:.2f} ms "
              f"of {wall:.1f} ms wall; rainc max "
              f"{float(model.state.rainc.max()):.4f} mm")
        out[name] = dict(ms=ms, cum_kernels=nker)
        del model
        torch.cuda.empty_cache()
    model = hydro_icbc_model(paths, dev, physics=SCHEME_C)
    model.run_icbc(HYDRO_CHECK[0])
    out["c_single12"] = model.decoupled()
    del model
    return out


def cumulus_run(i, device, conf=None, seed=None):
    """Phase 16c's run of CU_CASES[i] in f64 on ``device`` at 16x20x14
    over the 500 m hill with water, 3 steps with every alarm at step 0
    and the cumulus every step (``conf``: subexparam conf; ``seed``: T
    changed by 1e-15 with this seed): the decoupled fields, the
    hydrometeors and, on the hydrostatic core, rainc."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model, standard_atmosphere_state
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.preproc.terrain import synthetic_topo
    name, idyn, ds, dt, phys = CU_CASES[i]
    cfg = with_physics(RegCMConfig(), phys)
    cfg.core.idynamic = idyn
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 20, 14
    cfg.geo.ds, cfg.time.dt, cfg.time.dtcum = ds, dt, dt
    topo, _, mask = synthetic_topo(cfg, kind="gauss", height=500.0)
    grid = build_grid(cfg, ht=topo, landmask=mask)
    if idyn == 3:
        s0 = MolochCore(grid, cfg, device="cpu").initial_state(
            perturb=0.3, seed=1)
    else:
        s0 = standard_atmosphere_state(grid, cfg, "cpu", perturb=0.3,
                                       seed=1)
    s0 = moisten(s0, idyn, CU_QVFAC)
    if conf is not None:
        cfg.subex.conf = conf
    if seed is not None:
        s0 = perturb_t(s0, "t" if idyn == 3 else "t_a", seed)
    m = Model(cfg, grid=grid, device=device, dtype=torch.float64,
              initial_state=s0)
    m.run(3)
    if not m.check_finite():
        raise AssertionError(f"16c {name}: non-finite on {device} "
                             f"(conf {conf}, seed {seed})")
    d = m.decoupled()
    qx = m.state.qx if idyn == 3 else m.state.qx_a / m.state.ps_a[None]
    for j in range(1, qx.shape[0]):
        d[("qc", "qr", "qi", "qs")[j - 1]] = qx[j].cpu().numpy()
    if idyn != 3:
        d["rainc"] = m.state.rainc.cpu().numpy()
    return d


def cumulus_card_vs_cpu(dev, cpu):
    """Phase 16c: each case of CU_CASES on the card against the CPU in f64
    at 16x20x14 over the 500 m hill with water, 3 steps with every alarm
    at step 0 and the cumulus every step. As phase 5: with the saturation
    adjustment the trajectory turns roundoff into ~1e-6 (a threshold of
    condtq flips), so it is held to max(1e-7, 4 x the CPU run's spread
    under a 1e-15 relative change of T), the spread the largest of three
    such changes (one change's spread varies sevenfold with its seed), a
    hydrometeor beyond it only at the points where a threshold flipped
    (at most 1% of them); with the adjustment off (subexparam conf=0)
    the dynamical fields (ps, t, qv, u, v, w) are well conditioned and
    held to 1e-10. ``cpu``: each case's futures of spread_runs."""
    for i, case in enumerate(CU_CASES):
        name = case[0]
        runs = dict(gpu=cumulus_run(i, dev),
                    gpu_dry=cumulus_run(i, dev, 0.0))
        runs.update(results(cpu[i]))
        worst, flips = (0.0, ""), {}
        fields = [f for f in runs["cpu"] if f != "rainc"]
        for f in fields:
            want = runs["cpu"][f]
            err = rel_rms(runs["gpu"][f], want)
            lim = max(1e-7, 4.0 * max(
                rel_rms(runs[f"cpu_perturbed{seed}"][f], want)
                for seed in range(3)))
            worst = max(worst, (err / lim, f))
            if err < lim:
                continue
            off = np.abs(runs["gpu"][f] - want) > 1e-7 * np.abs(want).max()
            flips[f] = int(off.sum())
            if f not in ("qc", "qr", "qi", "qs") or off.mean() > 0.01:
                raise AssertionError(f"16c {name}: card and CPU disagree "
                                     f"on {f}: rel-RMS {err} (bound {lim})")
        # the dry runs' dynamical fields, as phases 5 and 7 hold them (the
        # autoconversion thresholds still act on qc)
        dry = max((rel_rms(runs["gpu_dry"][f], runs["cpu_dry"][f]), f)
                  for f in fields if f not in ("qc", "qr", "qi", "qs"))
        rain = (f", convective rain max {runs['cpu']['rainc'].max():.3e} mm"
                if "rainc" in runs["cpu"] else "")
        print(f"16c {name}, 3 steps f64 16x20x14, card vs CPU: worst field "
              f"{worst[1]} at {worst[0]:.3f} of its bound"
              + (f"; points past 1e-7 by a branch flip {flips}" if flips
                 else "") + f"; saturation adjustment off: worst {dry[1]} "
              f"rel-RMS {dry[0]:.3e} (bound 1e-10)" + rain)
        if not dry[0] <= 1e-10:
            raise AssertionError(f"16c {name}: card and CPU disagree with "
                                 f"the adjustment off on {dry[1]}: {dry[0]}")


def cumulus_rank(rank, paths):
    """Phase 16d on one rank of the 2x2 group: configuration C on test_001
    from the ICBC files for HYDRO_CHECK[0] steps (counters reset just
    before, read just after); the whole domain's fields (on rank 0)."""
    import torch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    mods = {"K1": k1, "K2": k2}
    model = hydro_icbc_model(paths, rank.device, rank.mesh(34, 48),
                             physics=SCHEME_C)
    reset(mods)
    k1.launches_sharded = 0
    model.run_icbc(HYDRO_CHECK[0])
    launches = read(mods)
    launches["K5c"] = k1.launches_sharded
    out = dict(launches=launches, finite=model.check_finite())
    dec = model.decoupled()
    out["dec"] = dec if rank.rank == 0 else None
    del model
    torch.cuda.empty_cache()
    return out


# -- phase 17: configuration D and the rest of the physics matrix --------
def band_cfg():
    """Configuration D over phase 13's one-day ICBC window."""
    from regcm_tpu_torch.config.params import RegCMConfig
    cfg = with_physics(RegCMConfig(), SCHEME_D)
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = BAND
    cfg.geo.i_band = 1
    cfg.geo.iproj, cfg.geo.clat = "NORMER", 0.0
    cfg.globdat.gdate2 = ICBC_END
    return cfg


def write_band_files(directory):
    """17a's input files, written by the port's preprocessors: D's DOMAIN
    file of a 500 m hill whose lower ground is water, and its one-day
    ICBC file with a 10 m/s jet."""
    from regcm_tpu_torch.preproc.icbc import generate_synthetic_icbc
    from regcm_tpu_torch.preproc.terrain import synthetic_topo, write_domain
    cfg = band_cfg()
    topo, lnd, mask = synthetic_topo(cfg, kind="gauss", height=500.0)
    paths = dict(band_domain=os.path.join(directory, "band_DOMAIN000.nc"),
                 band=os.path.join(directory, "band_ICBC.nc"))
    write_domain(cfg, paths["band_domain"], topo, lnd, mask)
    generate_synthetic_icbc(cfg, topo, paths["band"], jet=10.0)
    return paths


def band_model(paths, device, mesh=None):
    """Configuration D in f32 on its DOMAIN file's grid, cold-started from
    its ICBC file (the rank's block under a mesh)."""
    import torch
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    cfg = band_cfg()
    grid = build_grid_from_domain(cfg, paths["band_domain"])
    m = Model(cfg, grid=grid, device=device, dtype=torch.float32, mesh=mesh)
    m.init_from_icbc(ICBCReader(paths["band"], cfg.globdat.calendar))
    return m


def run_band(dev, smi, paths, mods):
    """Phase 17a: configuration D at full width on one card from its
    DOMAIN and ICBC files for D_STEPS steps."""
    import torch
    t0 = time.time()
    model = band_model(paths, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    grid = model.grid
    ocean = torch.as_tensor(grid.lndocn, device=dev) < 0.5
    tg0 = model.state.tg.clone()
    shape = f"{grid.jx}x{grid.iy}x{grid.kz}"
    print(f"17a. configuration D {SCHEME_D}, the tropical band (i_band=1, "
          f"NORMER about the equator) at {shape} (ds {model.cfg.geo.ds} km, "
          f"dt {model.cfg.dtsec} s, f32, {grid.iy * grid.jx} columns, xlat "
          f"{grid.xlat.min():.2f}..{grid.xlat.max():.2f}, land fraction "
          f"{float(np.mean(grid.lndocn)):.3f}; from ICBC, set-up "
          f"{time.time() - t0:.1f} s)")
    reset(mods)
    rows, rec = timed_steps(model, D_STEPS, (D_CHECK,))
    launches = read(mods)
    ncum = sum(1 for row in rows if row[3])
    print(f"17a path: {D_STEPS} steps, launches {launches} (K1 "
          f"{launches['K1'] / D_STEPS:.2f} a step, K2 "
          f"{launches['K2'] / ncum:.2f} a cumulus step)")
    if not model.check_finite():
        raise AssertionError("17a: non-finite state")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        raise AssertionError(f"17a bypassed K1 (Holtslag) or K2 (Emanuel): "
                             f"{launches}")
    dsst = (model.state.tg - tg0)[ocean]
    off = (model.state.tg - model.core.sst)[ocean]
    print(f"17a slab ocean after {D_STEPS} steps: SST change "
          f"{float(dsst.min()):.5f}..{float(dsst.max()):.5f} K, off the "
          f"forcing SST {float(off.min()):.5f}..{float(off.max()):.5f} K")
    if not float(dsst.abs().max()) > 0.0:
        raise AssertionError("17a: the slab SST did not move")
    d = model.decoupled()
    print(f"17a step {D_STEPS}: ps {d['ps'].min():.3f}..{d['ps'].max():.3f} "
          f"hPa, T {d['t'].min():.3f}..{d['t'].max():.3f} K, rainc max "
          f"{float(model.state.rainc.max()):.4f} mm")
    ms = class_ms(rows, "17a", smi, shape)
    next_cumulus_step(model)
    nker, busy, wall = step_kernels(model, lambda: model.run_icbc(1))
    print(f"17a cumulus step {model.nstep - 1} under the profiler: {nker} "
          f"device kernels, device busy {busy:.2f} ms of {wall:.1f} ms wall "
          f"({100.0 * busy / wall:.1f}%)")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"17a peak device memory {peak:.2f} GiB")
    operands = check_d_operands(model, mods)
    del model
    torch.cuda.empty_cache()
    return dict(ms=ms, cum_kernels=nker, peak_gib=peak, rec=rec[D_CHECK],
                per_step={k: v / D_STEPS for k, v in launches.items()},
                operands=operands)


def check_d_operands(model, mods):
    """17a's kernels on D's own operands: the next cumulus step of
    ``model`` runs with Holtslag's K1 call and Emanuel's K2 call
    recorded (copies of the first call's inputs of each); then each
    kernel is held against its plain version on them, and K2 also on
    clouds in every column at D's shape, at the f32 tolerance, and both
    are timed. Runs after the main path's counts were read."""
    import torch
    from regcm_tpu_torch.physics.cumulus import emanuel
    from regcm_tpu_torch.physics.pbl import holtslag
    next_cumulus_step(model)
    seen = {}
    sites = (("K1", holtslag, NAMES["K1"]), ("K2", emanuel, NAMES["K2"]))

    def recording(k, fn):
        def call(*args, **kw):
            seen.setdefault(k, [a.clone() for a in args])
            return fn(*args, **kw)
        return call

    for k, site, name in sites:
        setattr(site, name, recording(k, getattr(mods[k], name)))
    try:
        model.run_icbc(1)
    finally:
        for k, site, name in sites:
            setattr(site, name, getattr(mods[k], name))
    out = {}
    for k, _, name in sites:
        if k not in seen:
            raise AssertionError(f"17a: D's cumulus step made no {k} call")
        shape = tuple(seen[k][3].shape if k == "K1" else seen[k][0].shape)
        cases = [("D's operands", seen[k])]
        if k == "K2":
            # D's start is dry (no rain in 48 steps): K2 also takes phase
            # 3's synthetic profiles, a deep cloud in every column, at
            # D's shape
            nconv = int((seen[k][9] > 0.0).any(dim=1).sum())
            print(f"17a K2: {nconv} of {shape[0]} columns of D's cumulus "
                  f"step with a mass flux"
                  + (" (none: D's operands hold K2 on zeros)"
                     if nconv == 0 else ""))
            cases.append(("clouds at D's shape",
                          k2_inputs(shape, torch.float32, model.device)))
        for label, args in cases:
            out.setdefault(k, {})[label] = check_operands(
                k, mods[k], name, args, shape, label)
    return out


def check_operands(k, mod, name, args, shape, label):
    """Kernel ``k`` against its plain version on ``args`` (f32) at the
    f32 tolerance, then both timed; the stats of the kernels line."""
    import torch
    kern, plain = getattr(mod, name), getattr(mod, name + "_plain")
    got = kern(*args)
    counts = {}
    want = plain(*args, counts=counts) if k == "K2" else plain(*args)
    torch.cuda.synchronize()
    if k == "K2":
        rel, ab = max(rel_err(got[key], want[key]) for key in mod.KEYS)
        scale = max(float(want[key].abs().max()) for key in mod.KEYS)
    else:
        rel, ab = rel_err(got, want)
        scale = float(want.abs().max())
    tol = TOL["float32"][k]
    print(f"17a {k} {name} on {label} {shape} (f32): max rel err "
          f"{rel:.3e} (max abs {ab:.3e}, largest output {scale:.3e}, tol "
          f"{tol:g})")
    if not rel <= tol:
        raise AssertionError(f"17a: {k} disagrees with its plain version "
                             f"on {label}: {rel}")
    b_ms, b_by, _, _ = bound(k, shape, 4, counts)
    st = dict(shape=list(shape), max_abs_err=ab, max_rel_err=rel,
              largest_output=scale,
              ms=time_ms(lambda: kern(*args), D_REPS),
              plain_ms=time_ms(lambda: plain(*args), D_REPS),
              bound_ms=b_ms, bound_by=b_by)
    print(f"17a {k} on {label}: kernel {st['ms']:.4f} ms, plain "
          f"{st['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return st


def _water_patches(lndocn):
    """(lake, cold sea) of a grid's cross points, the CPU tests' patches
    (tests/_torch_surface_settings.water_patches) on (iy, jx)."""
    from tests._torch_surface_settings import water_patches
    return tuple(np.pad(m, ((0, 1), (0, 1))) for m in
                 water_patches(np.asarray(lndocn)[:-1, :-1]))


def new_setting_model(paths, dev, st):
    """A 17c setting on test_001 from phase 13's ICBC files (f32): the
    physics overrides, nsg, and a lake and a 270 K sea where asked."""
    import torch
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    cfg = with_physics(hydro_icbc_cfg(), st["physics"])
    cfg.dim.nsg = st.get("nsg", 1)
    grid = build_grid_from_domain(cfg, paths["domain"])
    if st.get("lake"):
        lake, sea = _water_patches(grid.lndocn)
        grid.extras["dhlake"] = np.where(lake, 20.0, 0.0)
    m = Model(cfg, grid=grid, device=dev, dtype=torch.float32)
    if st.get("lake"):
        m.core.sst = torch.where(torch.as_tensor(sea, device=dev),
                                 torch.full_like(m.core.sst, 270.0),
                                 m.core.sst)
    m.init_from_icbc(ICBCReader(paths["hydro"], cfg.globdat.calendar))
    return m


def next_step_of(model, kind):
    """Run up to the next step of alarm class ``kind``."""
    while step_kind(model._flags()) != kind:
        model.run_icbc(1)


def run_new_settings(dev, smi, paths, mods):
    """Phase 17c: each NEW_SETTINGS case on test_001 from phase 13's ICBC
    files for CU_STEPS steps: ms/step of each alarm class, K1 and K2
    launches, a surface step's device kernels."""
    import torch
    out = {}
    for name, st in NEW_SETTINGS.items():
        model = new_setting_model(paths, dev, st)
        reset(mods)
        rows, _ = timed_steps(model, CU_STEPS)
        launches = read(mods)
        print(f"17c {name} {st} on test_001 from ICBC: {CU_STEPS} steps, "
              f"launches {launches}")
        if not model.check_finite():
            raise AssertionError(f"17c {name}: non-finite state")
        if launches["K2"] <= 0:
            raise AssertionError(f"17c {name} bypassed K2: {launches}")
        if st["physics"].get("ibltyp", 1) == 1 and launches["K1"] <= 0:
            raise AssertionError(f"17c {name} bypassed K1: {launches}")
        ms = class_ms(rows, f"17c {name}", smi, "34x48x18")
        next_step_of(model, "surface")
        nker, busy, wall = step_kernels(model, lambda: model.run_icbc(1))
        print(f"17c {name} surface step {model.nstep - 1} under the "
              f"profiler: {nker} device kernels, device busy {busy:.2f} ms "
              f"of {wall:.1f} ms wall")
        if st.get("lake"):
            s = model.state
            print(f"17c {name}: sea ice at "
                  f"{int((s.seaice[0] > 0).sum())} points, lake surface "
                  f"{float(s.tlak[0].min()):.3f}..{float(s.tlak[0].max()):.3f}"
                  f" C, skin SST set at {int((s.dcsst[2] > 100).sum())}")
        out[name] = dict(ms=ms, srf_kernels=nker)
        del model
        torch.cuda.empty_cache()
    return out


def new_case_start(case):
    """A NEW_CASES case at 16x20x14 over the 500 m hill with water: the
    configs (saturation adjustment on, off), the grid and the moistened
    start (CPU, f64)."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import (nh_initial_state,
                                        standard_atmosphere_state)
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.preproc.terrain import synthetic_topo
    from tests._torch_surface_settings import subgrid_landuse
    name, idyn, ds, dt, phys, geo, nsg, lake = case
    cfgs = {}
    for conf in (None, 0.0):
        cfg = with_physics(RegCMConfig(), phys)
        cfg.core.idynamic = idyn
        cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 20, 14
        cfg.dim.nsg = nsg
        cfg.geo.ds, cfg.time.dt, cfg.time.dtcum = ds, dt, dt
        for k, v in geo.items():
            setattr(cfg.geo, k, v)
        if lake:
            cfg.physics.extras["lake_ndpmax"] = 30
        if conf is not None:
            cfg.subex.conf = conf
        cfgs[conf] = cfg
    cfg = cfgs[None]
    topo, _, mask = synthetic_topo(cfg, kind="gauss", height=500.0)
    grid = build_grid(cfg, ht=topo, landmask=mask)
    if lake:
        grid.extras["dhlake"] = np.where(_water_patches(grid.lndocn)[0],
                                         20.0, 0.0)
    if nsg > 1:
        subgrid_landuse(grid)
    kw = dict(perturb=0.3, seed=1)
    if idyn == 3:
        s0 = MolochCore(grid, cfg, device="cpu").initial_state(**kw)
    elif idyn == 2:
        s0 = nh_initial_state(grid, cfg, "cpu", torch.float64, **kw)
    else:
        s0 = standard_atmosphere_state(grid, cfg, "cpu", **kw)
    return cfgs, grid, moisten(s0, idyn, CU_QVFAC)


def new_case_run(i, device, conf=None, seed=None):
    """Phase 17d's run of NEW_CASES[i] in f64 on ``device``, 3 steps from
    new_case_start (``conf``: None or 0.0, the saturation adjustment on
    or off; ``seed``: T changed by 1e-15 with this seed): the decoupled
    fields, the hydrometeors and the surface state (tg, hfx, qfx)."""
    import torch
    from regcm_tpu_torch.driver import Model
    case = NEW_CASES[i]
    name, idyn = case[0], case[1]
    cfgs, grid, s0 = new_case_start(case)
    if seed is not None:
        s0 = perturb_t(s0, "t" if idyn == 3 else "t_a", seed)
    m = Model(cfgs[conf], grid=grid, device=device, dtype=torch.float64,
              initial_state=s0)
    if case[7]:
        lake, sea = _water_patches(grid.lndocn)
        m.core.sst = torch.where(
            torch.as_tensor(sea, device=m.core.sst.device),
            torch.full_like(m.core.sst, 270.0), m.core.sst)
    m.run(3)
    if not m.check_finite():
        raise AssertionError(f"17d {name}: non-finite on {device} "
                             f"(conf {conf}, seed {seed})")
    d = m.decoupled()
    qx = m.state.qx if idyn == 3 else m.state.qx_a / m.state.ps_a[None]
    for j in range(1, qx.shape[0]):
        d[("qc", "qr", "qi", "qs")[j - 1]] = qx[j].cpu().numpy()
    for k in ("tg", "hfx", "qfx"):
        d[k] = getattr(m.state, k).cpu().numpy()
    return d


def new_card_vs_cpu(dev, cpu):
    """Phase 17d: each NEW_CASES case on the card against the CPU in f64
    at 16x20x14, 3 steps, held as phase 16c holds its cases: the spread
    rule with three seeds (a hydrometeor past it at most at 1% of the
    points), and the dynamical fields with the saturation adjustment off
    to 1e-10; the surface state (tg, hfx, qfx) within the same rule.
    ``cpu``: each case's futures of spread_runs."""
    for i, case in enumerate(NEW_CASES):
        name = case[0]
        runs = dict(gpu=new_case_run(i, dev),
                    gpu_dry=new_case_run(i, dev, 0.0))
        runs.update(results(cpu[i]))
        worst, flips = (0.0, ""), {}
        for f in runs["cpu"]:
            want = runs["cpu"][f]
            err = rel_rms(runs["gpu"][f], want)
            lim = max(1e-7, 4.0 * max(
                rel_rms(runs[f"cpu_perturbed{seed}"][f], want)
                for seed in range(3)))
            worst = max(worst, (err / lim, f))
            if err < lim:
                continue
            off = np.abs(runs["gpu"][f] - want) > 1e-7 * np.abs(want).max()
            flips[f] = int(off.sum())
            if f not in ("qc", "qr", "qi", "qs") or off.mean() > 0.01:
                raise AssertionError(f"17d {name}: card and CPU disagree "
                                     f"on {f}: rel-RMS {err} (bound {lim})")
        dyn = [f for f in ("ps", "t", "qv", "u", "v", "w") if f in runs["cpu"]]
        dry = max((rel_rms(runs["gpu_dry"][f], runs["cpu_dry"][f]), f)
                  for f in dyn)
        print(f"17d {name}, 3 steps f64 16x20x14, card vs CPU: worst field "
              f"{worst[1]} at {worst[0]:.3f} of its bound"
              + (f"; points past 1e-7 by a branch flip {flips}" if flips
                 else "") + f"; saturation adjustment off: worst {dry[1]} "
              f"rel-RMS {dry[0]:.3e} (bound 1e-10)")
        if not dry[0] <= 1e-10:
            raise AssertionError(f"17d {name}: card and CPU disagree with "
                                 f"the adjustment off on {dry[1]}: {dry[0]}")


def crm_run(device, mesh=None):
    """17b's CRM, the CPU tests' doubly periodic run (tests/
    _torch_surface_settings.PERIODIC["crm"]: hydrostatic, default
    physics, f64) on ``device``: the whole domain's fields."""
    from tests._torch_surface_settings import periodic_run
    return periodic_run("crm", mesh=mesh, device=device)


def band_rank(rank, paths):
    """Phase 17b on one rank of the 2x2 group: configuration D at full
    width for D_CHECK steps (counters and halo tallies reset just before,
    read just after), then the CRM in f64; the whole domain's fields (on
    rank 0)."""
    import torch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.parallel import halo
    mods = {"K1": k1, "K2": k2}
    model = band_model(paths, rank.device, rank.mesh(BAND[0], BAND[1]))
    reset(mods)
    k1.launches_sharded = 0
    halo.exchanges = halo.bytes_sent = 0
    model.run_icbc(D_CHECK)
    launches = read(mods)
    launches["K5c"] = k1.launches_sharded
    out = dict(launches=launches, finite=model.check_finite(),
               exchanges_per_step=halo.exchanges / D_CHECK,
               bytes_per_step=halo.bytes_sent / D_CHECK)
    dec = model.decoupled()
    out["dec"] = dec if rank.rank == 0 else None
    del model
    torch.cuda.empty_cache()
    from tests._torch_surface_settings import PERIODIC
    crm = crm_run(rank.device, rank.mesh(PERIODIC["crm"]["iy"],
                                         PERIODIC["crm"]["jx"]))
    out["crm"] = crm if rank.rank == 0 else None
    return out


def check_band_decomposed(res, backend, d17, crm_ref):
    """17b's checks of the 2x2 group's band and CRM runs against one
    card: D bit for bit at D_CHECK, the CRM within 1e-12."""
    from tests._torch_surface_settings import PERIODIC
    for r, out in enumerate(res):
        h = out["band"]
        print(f"  rank {r} configuration D: launches {h['launches']}, "
              f"{h['exchanges_per_step']:.1f} halo exchanges and "
              f"{h['bytes_per_step'] / 1e6:.3f} MB sent a step")
        if not h["finite"]:
            raise AssertionError(f"rank {r}: non-finite decomposed "
                                 f"configuration D")
        if h["launches"]["K5c"] <= 0 or h["launches"]["K2"] <= 0 \
                or h["launches"]["K1"] != 0:
            raise AssertionError(f"rank {r} ({backend}): the decomposed "
                                 f"configuration D bypassed K5c or K2: "
                                 f"{h['launches']}")
    dec = res[0]["band"]["dec"]
    for f in HYDRO_FIELDS:
        same = np.array_equal(dec[f], d17[f])
        print(f"  configuration D f32 {BAND[1]}x{BAND[0]}x{BAND[2]} step "
              f"{D_CHECK}, {backend} 2x2 vs one card (17a), {f}: "
              f"{'bit-identical' if same else 'DIFFERENT'}, rel-RMS "
              f"{rel_rms(dec[f], d17[f]):.3e}")
        if not same:
            raise AssertionError(f"decomposed configuration D ({backend}) "
                                 f"differs from one card in {f}")
    crm = res[0]["band"]["crm"]
    if not crm["finite"]:
        raise AssertionError("non-finite decomposed CRM")
    worst = max((max_rel(crm["fields"][f], w), f)
                for f, w in crm_ref["fields"].items())
    st = PERIODIC["crm"]
    print(f"  CRM {st['iy']}x{st['jx']}x14 f64 (doubly periodic, "
          f"{st['steps']} steps), {backend} 2x2 vs one card: worst field "
          f"{worst[1]} max rel err {worst[0]:.3e} (bound 1e-12)")
    if not worst[0] <= 1e-12:
        raise AssertionError(f"decomposed CRM ({backend}) disagrees in "
                             f"{worst[1]}: {worst[0]}")



class Chain:
    """Phase 18a's restart chain riding on an earlier phase's run: the
    model writes its SAV after step ``at`` (the write's seconds kept)
    and its state and boundary are kept on the card after step
    ``end``."""

    def __init__(self, name, directory):
        self.name = name
        self.at, self.end = CHAIN_STEPS[name]
        self.path = os.path.join(directory, f"{name}_SAV.nc")
        self.write_s = None
        self.want = None

    def __call__(self, model):
        import torch
        if model.nstep == self.at:
            torch.cuda.synchronize()
            t0 = time.time()
            model.save_restart(self.path)
            self.write_s = time.time() - t0
        elif model.nstep == self.end:
            self.want = [{k: v.clone() for k, v in nt._asdict().items()
                          if v is not None}
                         for nt in (model.state, model.bdy)]


def run_restart_chains(dev, smi, paths, chains):
    """Phase 18a: each chain's SAV loaded into a fresh Model (the ICBC
    reader re-attached), run to the chain's end and held to the
    uninterrupted run bit for bit in every state and boundary field."""
    import torch
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    for name, ch in chains.items():
        if ch.write_s is None or ch.want is None:
            raise AssertionError(f"restart chain {name}: the earlier run "
                                 f"did not pass steps {ch.at} and {ch.end}")
        if name == "test_001":
            model = hydro_icbc_model(paths, dev)
        elif name == "MOLOCH":
            model = moloch_icbc_model(paths, dev, init=False)
        else:
            cfg = nh_flagship_cfg()
            model = nh_model(cfg, build_grid(cfg), dev)
        torch.cuda.synchronize()
        t0 = time.time()
        model.load_restart(ch.path)
        torch.cuda.synchronize()
        read_s = time.time() - t0
        t0 = time.time()
        if name == "NH":
            model.run(ch.end - model.nstep)
        else:
            icbc = paths["hydro" if name == "test_001" else "moloch"]
            model.attach_icbc(ICBCReader(icbc, model.cfg.globdat.calendar))
            model.run_icbc(ch.end - model.nstep)
        run_s = time.time() - t0
        bad = [f"{part}.{k}" for part, nt, want in
               (("state", model.state, ch.want[0]),
                ("bdy", model.bdy, ch.want[1]))
               for k, v in nt._asdict().items()
               if v is not None and not torch.equal(v, want[k])]
        nfield = len(ch.want[0]) + len(ch.want[1])
        print(f"restart chain {name} (f32): SAV after step {ch.at}, "
              f"{os.path.getsize(ch.path) / 1e6:.1f} MB, written in "
              f"{ch.write_s:.2f} s, read in {read_s:.2f} s; steps "
              f"{ch.at}..{ch.end - 1} after the load in {run_s:.2f} s; "
              + ("every one of the " + str(nfield) + " state and boundary "
                 "fields bit-identical to the uninterrupted run"
                 if not bad else f"DIFFERENT: {bad}") + f", on {smi}")
        if bad:
            raise AssertionError(f"restart chain {name} differs from the "
                                 f"uninterrupted run in {bad}")
        del model
        ch.want = None
        torch.cuda.empty_cache()


def timed(fn, log):
    """``fn`` with each call's synchronised host-clock ms added to
    ``log``."""
    import torch

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log.append(1000.0 * (time.time() - t0))
        return out
    return wrapped


def run_output(dev, smi, paths, sav, directory):
    """Phase 18c: run_with_output at the MOLOCH flagship from the SAV
    ``sav`` (step 12) over OUTPUT_STEPS steps, ATM, SRF and RAD every
    OUTPUT_EVERY steps, on the NetCDF and the Zarr backend in turn: the
    ms of plain and output steps and of each writer (the device record
    and its host copy), the writer thread's encoding, the bytes; then
    the Zarr stores against the NetCDF files record for record, and the
    last ATM record against Model.decoupled() cut and rotated."""
    import torch
    from regcm_tpu_torch.io.ncio import read_nc
    from regcm_tpu_torch.io.zarrio import read_zarr
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    dirs = {}
    for backend in ("netcdf", "zarr"):
        model = moloch_icbc_model(paths, dev, init=False)
        model.load_restart(sav)
        model.attach_icbc(ICBCReader(paths["moloch"],
                                     model.cfg.globdat.calendar))
        o = model.cfg.out
        o.atmfrq = o.srffrq = o.radfrq = OUTPUT_EVERY * model.dtsec / 3600.0
        dirs[backend] = os.path.join(directory, f"out_{backend}")
        st = model.open_output(dirs[backend], backend=backend)
        writers, encode = {}, {}
        for w in ("atm", "srf", "rad"):
            writers[w] = []
            setattr(st, f"write_{w}", timed(getattr(st, f"write_{w}"),
                                            writers[w]))
            encode[w] = []
            sw = getattr(st, w)
            sw.write_record = timed(sw.write_record, encode[w])
        start = model.nstep
        steps = []
        for _ in range(OUTPUT_STEPS):
            torch.cuda.synchronize()
            t0 = time.time()
            model.run_with_output(1)
            torch.cuda.synchronize()
            steps.append((model.nstep, 1000.0 * (time.time() - t0)))
        t0 = time.time()
        st.close()
        drain_s = time.time() - t0
        if not model.check_finite():
            raise AssertionError(f"18c ({backend}): non-finite state")
        plain = [ms for n, ms in steps[1:] if n % OUTPUT_EVERY]
        alarm = [ms for n, ms in steps[1:] if not n % OUTPUT_EVERY]
        size = {}
        for f in os.listdir(dirs[backend]):
            p = os.path.join(dirs[backend], f)
            size[f.split("_")[-1].split(".")[0]] = sum(
                os.path.getsize(os.path.join(d, x))
                for d, _, xs in os.walk(p) for x in xs) \
                if os.path.isdir(p) else os.path.getsize(p)
        mean = lambda xs: sum(xs) / max(len(xs), 1)
        g = model.grid
        print(f"18c MOLOCH {g.jx}x{g.iy}x{g.kz} f32 run_with_output, "
              f"{backend}: steps "
              f"{start}..{model.nstep - 1}, {st.atm.nrec} ATM records; "
              f"plain step {mean(plain):.3f} ms ({len(plain)}), output "
              f"step {mean(alarm):.3f} ms ({len(alarm)}); writers (device "
              f"record + host copy, synchronised) "
              + ", ".join(f"{w} {mean(v):.3f} ms" for w, v in writers.items())
              + "; encoding on the writer thread "
              + ", ".join(f"{w} {mean(v):.3f} ms" for w, v in encode.items())
              + f"; close (drain) {drain_s:.2f} s; bytes "
              + ", ".join(f"{k} {v / 1e6:.2f} MB" for k, v in
                          sorted(size.items()))
              + f", on {smi}")
        if st.atm.nrec != OUTPUT_STEPS // OUTPUT_EVERY + 1:
            raise AssertionError(f"18c ({backend}): {st.atm.nrec} ATM "
                                 "records")
        if backend == "netcdf":
            dec = model.decoupled()
            cut = lambda a: a[..., :g.iy - 1, :g.jx - 1]
            f32 = lambda k: cut(np.asarray(g.extras[k])).astype(np.float32)
            rc, rs = f32("rotcos"), f32("rotsin")
            u, v = cut(dec["u"]), cut(dec["v"])
            want = dict(ta=cut(dec["t"]), hus=cut(dec["qv"]),
                        clw=cut(dec["qc"]), ps=cut(dec["ps"]),
                        ua=u * rc - v * rs, va=v * rc + u * rs)
            atm = read_nc(os.path.join(dirs[backend], [
                f for f in os.listdir(dirs[backend]) if "_ATM." in f][0]))
            bad = [k for k, w in want.items()
                   if not np.array_equal(atm[k][-1], w)]
            print(f"18c last ATM record (step {model.nstep}) against "
                  f"Model.decoupled() cut and rotated: "
                  + ("equal in " + ", ".join(want) if not bad
                     else f"DIFFERENT in {bad}"))
            if bad:
                raise AssertionError(f"18c: the ATM record differs from "
                                     f"the decoupled state in {bad}")
        del model, st
        torch.cuda.empty_cache()
    names = sorted(os.listdir(dirs["netcdf"]))
    bad = []
    for fn in names:
        nc = read_nc(os.path.join(dirs["netcdf"], fn))
        zr = read_zarr(os.path.join(dirs["zarr"],
                                    fn.replace(".nc", ".zarr")))
        # a variable without a record (STS before its first day
        # boundary) has no array in the store yet
        bad += [f"{fn}:{k}" for k, v in nc.items()
                if (k in zr or v.size) and not (
                    k in zr and np.array_equal(zr[k], v))]
    print(f"18c Zarr stores against the NetCDF files ({len(names)} "
          f"streams, every variable with records, record for record): "
          + ("equal" if not bad else f"DIFFERENT in {bad}"))
    if bad:
        raise AssertionError(f"18c: Zarr differs from NetCDF in {bad}")


def sl_physics(iqmsl):
    return dict(isladvec=1, iqmsl=iqmsl)


def sl_single(dev, paths):
    """Phases 18b and 18d's one-card references: test_001 from phase 13's
    files with the semi-Lagrangian advection, the decoupled fields at
    step SL_STEPS[0] with iqmsl 0 and 1, and at SL_STEPS[1] with iqmsl
    1."""
    import torch
    ref = {}
    for q in (0, 1):
        model = hydro_icbc_model(paths, dev, physics=sl_physics(q))
        model.run_icbc(SL_STEPS[0])
        ref[q] = model.decoupled()
        if q == 1:
            model.run_icbc(SL_STEPS[1] - SL_STEPS[0])
            ref["chain"] = model.decoupled()
        del model
    torch.cuda.empty_cache()
    return ref


def sl_rank(rank, paths):
    """Phases 18b and 18d on one rank of a 2x2 group: test_001 with the
    semi-Lagrangian advection, iqmsl 0 and 1, to step SL_STEPS[0] (the
    whole domain's decoupled fields on rank 0); with iqmsl 1 a SAV at
    that step (rank 0 writes it), the run on to step SL_STEPS[1], and a
    fresh Model loaded from the SAV run to that step, held to it on every rank's block bit for
    bit; K5c's launches."""
    import torch
    import torch.distributed as dist
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    dev = rank.device
    out = {}
    for q in (0, 1):
        model = hydro_icbc_model(paths, dev, rank.mesh(34, 48),
                                 physics=sl_physics(q))
        k1.launches_sharded = 0
        model.run_icbc(SL_STEPS[0])
        out[f"k5c_{q}"] = k1.launches_sharded
        dec = model.decoupled()
        out[q] = dec if rank.rank == 0 else None
        if q != 1:
            continue
        sav = os.path.join(paths["phase18"], f"sl_{rank.backend}_SAV.nc")
        model.save_restart(sav)
        model.run_icbc(SL_STEPS[1] - SL_STEPS[0])
        dec = model.decoupled()
        out["chain"] = dec if rank.rank == 0 else None
        fresh = hydro_icbc_model(paths, dev, rank.mesh(34, 48),
                                 physics=sl_physics(q))
        fresh.load_restart(sav)
        fresh.attach_icbc(ICBCReader(paths["hydro"],
                                     fresh.cfg.globdat.calendar))
        fresh.run_icbc(SL_STEPS[1] - SL_STEPS[0])
        same = torch.tensor(int(all(
            torch.equal(a, b) for nt0, nt1 in ((model.state, fresh.state),
                                               (model.bdy, fresh.bdy))
            for a, b in zip(nt0, nt1) if a is not None)))
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        out["chain_same"] = bool(same)
        dist.barrier()
        if rank.rank == 0:
            os.remove(sav)
        del model, fresh
    torch.cuda.empty_cache()
    return out


def check_sl_decomposed(res, backend, ref):
    """Phases 18b and 18d's checks of a 2x2 group's ``sl_rank`` results
    against the one-card references ``ref``."""
    out = res[0]["sl"]
    for r, o in enumerate(res):
        s = o["sl"]
        if min(s["k5c_0"], s["k5c_1"]) <= 0:
            raise AssertionError(f"rank {r} ({backend}): the decomposed "
                                 f"semi-Lagrangian run bypassed K5c")
    for key, step in ((0, SL_STEPS[0]), (1, SL_STEPS[0]),
                      ("chain", SL_STEPS[1])):
        what = (f"iqmsl {key}" if key != "chain"
                else "iqmsl 1 (restart chain's run)")
        bad = [f for f in HYDRO_FIELDS
               if not np.array_equal(out[key][f], ref[key][f])]
        print(f"  18{'d' if key != 'chain' else 'b'} test_001 isladvec=1 "
              f"{what} f32 step {step}, {backend} 2x2 vs one card: "
              + ("bit-identical in " + ", ".join(HYDRO_FIELDS) if not bad
                 else "DIFFERENT in " + ", ".join(
                     f"{f} (rel-RMS {rel_rms(out[key][f], ref[key][f]):.3e})"
                     for f in bad)))
        if bad:
            raise AssertionError(f"decomposed semi-Lagrangian test_001 "
                                 f"({backend}, {what}) differs from one "
                                 f"card in {bad}")
    chain = all(o["sl"]["chain_same"] for o in res)
    print(f"  18b 2x2 restart chain ({backend}, SAV at step {SL_STEPS[0]}, "
          f"fresh Model to step {SL_STEPS[1]}): every state and boundary "
          f"field " + ("bit-identical to the uninterrupted 2x2 run"
                       if chain else "NOT bit-identical"))
    if not chain:
        raise AssertionError(f"18b ({backend}): the restarted 2x2 run "
                             f"differs from the uninterrupted one")


# -- phase 19: the aerosol chemistry and its tracer transport ------------
def chem_setup(cfg, sim, idirect=0):
    """ichem=1 with chemsimtype ``sim`` on ``cfg``."""
    cfg.physics.ichem = 1
    cfg.chem.chemsimtype = sim
    cfg.chem.idirect = idirect
    return cfg


def desert(grid):
    """The land of ``grid`` marked desert (landuse 8), as the JAX
    package's tests/test_chem.py does, so that dust emits."""
    grid.extras["lveg"] = np.where(np.asarray(grid.lndocn) > 0.5, 8, 15)
    return grid


def westerly(model, wind=CHEM_WIND):
    """``wind`` m/s added to the zonal wind at every level (the ICBC
    files' jet is calm at the surface, where the dust and the sea salt
    are lifted; tests/test_chem.py's runs set 12 m/s the same way)."""
    import torch
    from regcm_tpu_torch.dynamics import stencil
    s = model.state
    if model.idynamic == 3:
        model.state = s._replace(u=s.u + wind)
        return model
    with stencil.topology(model.core.periodic_x, model.core.periodic_y,
                          mesh=model.mesh):
        psd = stencil.cross2dot(s.ps_a)
    du = wind * psd[None] * torch.ones_like(s.u_a)
    model.state = s._replace(u_a=s.u_a + du, u_b=s.u_b + du)
    return model


def seed_tracers(model, which, peak=1.0e-9):
    """A seeded initial profile of the tracers ``which`` (no emission
    inventory is in the repository, so the JAX package's carbon and
    sulfur sources are zero): ``peak`` kg/kg at the surface falling off
    over four levels, horizontally uniform, on both time levels."""
    import torch
    s = model.state
    kz = model.grid.kz
    prof = torch.as_tensor(peak * np.exp(-((np.arange(kz) - (kz - 1))
                                           / 4.0) ** 2),
                           dtype=s.chi_b.dtype, device=s.chi_b.device)
    if model.idynamic == 3:
        chi = s.chi_b.clone()
        chi[which] = prof[:, None, None]
        model.state = s._replace(chi_b=chi)
        return model
    chi = s.chi_a.clone()
    chi[which] = prof[:, None, None] * s.ps_a[None]
    model.state = s._replace(chi_a=chi, chi_b=chi.clone())
    return model


def e_model(paths, device, mesh=None, dtype=None, files="band"):
    """Configuration E (D plus AERO) in f32 from phase 17's DOMAIN and
    ICBC files (``files="band"``) or on test_001's widths from phase 13's
    (``files="test_001"``, 19e), the land desert, a 10 m/s westerly added,
    the start moistened by ``moisten`` (qv E_QVFAC times the files': the
    ICBC start alone does not convect, and E's Emanuel columns would
    then move no tracer and wash none out), the carbon and sulfur
    tracers seeded (the rank's block under a mesh)."""
    import torch
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    if files == "band":
        cfg, dom, icbc = band_cfg(), paths["band_domain"], paths["band"]
    else:
        cfg = with_physics(hydro_icbc_cfg(), SCHEME_D)
        dom, icbc = paths["domain"], paths["hydro"]
    cfg = chem_setup(cfg, "AERO")
    grid = desert(build_grid_from_domain(cfg, dom))
    m = Model(cfg, grid=grid, device=device, dtype=dtype or torch.float32,
              mesh=mesh)
    m.init_from_icbc(ICBCReader(icbc, cfg.globdat.calendar))
    m = westerly(m)
    m.state = moisten(m.state, m.idynamic, E_QVFAC)
    return seed_tracers(m, E_SEEDED)


def chem_fields(model):
    """The decoupled fields and the tracers (both levels) and the
    accumulators of the whole domain, host arrays."""
    d = model.decoupled()
    for k in ("chi_a", "chi_b", "chemdiag"):
        v = getattr(model.state, k)
        if model.mesh is not None:
            v = model.mesh.gather(v)
        d[k] = v.cpu().numpy()
    return d


def burdens(model):
    """Each AERO tracer group's domain-mean column burden and its mean
    accumulated emission, dry and wet deposition (kg/m²)."""
    import torch
    from regcm_tpu_torch.chem.species import build_species
    s = model.state
    dsig = torch.as_tensor(np.asarray(model.grid.dsigma), dtype=s.chi_a.dtype,
                           device=s.chi_a.device)[None, :, None, None]
    col = (s.chi_a * dsig).sum(dim=1) * 1000.0 / 9.80665
    names = build_species(model.cfg.chem.chemsimtype).names
    out = {}
    for group in E_GROUPS:
        idx = [n for n, nm in enumerate(names) if nm.startswith(group)]
        out[group] = [float(col[idx].sum(dim=0).mean())] + [
            float(s.chemdiag[a][idx].sum(dim=0).mean()) for a in range(3)]
    return out


def run_chem_e(dev, smi, paths, mods):
    """Phase 19a: configuration E at full width from phase 17's files for
    E_STEPS steps: launches (K1 twice a step: Holtslag's fields and the
    tracers; K2 in its tracer form on the cumulus steps), the ms/step of
    each alarm class, a chemistry step's device kernels and busy share,
    the peak memory, each tracer group's burden and accumulators; then K1
    (ns = ntr) and K2's tracer form against their plain versions on the
    operands of one of E's cumulus steps, in f32 and f64, timed."""
    import torch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    t0 = time.time()
    model = e_model(paths, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    g = model.grid
    shape = f"{g.jx}x{g.iy}x{g.kz}"
    print(f"19a. configuration E = D {SCHEME_D} plus AERO ({model.core.ntr} "
          f"tracers), the tropical band at {shape} (ds {model.cfg.geo.ds} "
          f"km, dt {model.cfg.dtsec} s, f32, the land desert, carbon and "
          f"sulfur seeded; from ICBC moistened (qv x {E_QVFAC}), set-up "
          f"{time.time() - t0:.1f} s)")
    reset(mods)
    k2.launches_tracers = 0
    rows, rec = timed_steps(model, E_STEPS, (E_CHECK,))
    launches = read(mods)
    tracer_k2 = k2.launches_tracers
    ncum = sum(1 for row in rows if row[3])
    print(f"19a path: {E_STEPS} steps, launches {launches} (K1 "
          f"{launches['K1'] / E_STEPS:.2f} a step; K2 {tracer_k2} in the "
          f"tracer form over {ncum} cumulus steps)")
    if not model.check_finite():
        raise AssertionError("19a: non-finite state")
    if launches["K1"] != 2 * E_STEPS or tracer_k2 != ncum \
            or launches["K2"] != ncum:
        raise AssertionError(f"19a bypassed K1's tracer solve or K2's "
                             f"tracer form: {launches}, {tracer_k2}")
    ms = class_ms(rows, "19a", smi, shape)
    b = burdens(model)
    for group, (burden, em, dd, wd) in b.items():
        print(f"19a step {E_STEPS} {group}: mean burden {burden:.4e} kg/m2, "
              f"emitted {em:.4e}, dry-deposited {dd:.4e}, wet-deposited "
              f"{wd:.4e} kg/m2")
    if not (b["DUST"][1] > 0.0 and b["SSLT"][1] > 0.0):
        raise AssertionError(f"19a: no dust or sea-salt emission: {b}")
    rainc = float(model.state.rainc.max())
    print(f"19a step {E_STEPS}: convective rain max {rainc:.4f} mm, "
          f"large-scale {float(model.state.rainnc.max()):.4f} mm")
    if not (rainc > 0.0 and b["DUST"][3] > 0.0):
        raise AssertionError(f"19a: E rained no convective rain or washed "
                             f"no dust out: rainc {rainc}, {b}")
    next_cumulus_step(model)
    nker, busy, wall = step_kernels(model, lambda: model.run_icbc(1))
    print(f"19a cumulus step {model.nstep - 1} (chemistry every step) under "
          f"the profiler: {nker} device kernels, device busy {busy:.2f} ms "
          f"of {wall:.1f} ms wall ({100.0 * busy / wall:.1f}%)")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"19a peak device memory {peak:.2f} GiB on {smi}")
    operands = check_e_operands(model, mods)
    del model
    torch.cuda.empty_cache()
    return dict(ms=ms, rec=rec[E_CHECK], peak_gib=peak,
                per_step=dict(K1=launches["K1"] / E_STEPS,
                              K2=tracer_k2 / ncum),
                tracer_launches=tracer_k2, operands=operands)


def check_e_operands(model, mods):
    """19a's kernels on E's own operands: the next cumulus step runs with
    the tracers' K1 call (ns = ntr) and K2's tracer-form call recorded
    (copies of the inputs); then each kernel, and K2's tracer form on
    synthetic clouds at E's shape, against its plain version in f32
    (1e-5) and in f64 (the operands cast; 1e-12, and K2's eight terms at
    their 1e-10), timed in f32 with its device time beside its bound.
    Runs after the main path's counts were read."""
    import torch
    from regcm_tpu_torch.physics.cumulus import emanuel
    from regcm_tpu_torch.physics.pbl import holtslag
    ntr = model.core.ntr
    next_cumulus_step(model)
    seen = {}
    k1f, k2f = mods["K1"].pbl_tridiag, mods["K2"].emanuel_mixing

    def k1_rec(*args):
        if args[3].shape[0] == ntr:
            seen.setdefault("K1", [a.clone() for a in args])
        return k1f(*args)

    def k2_rec(*args, **kw):
        if kw.get("tra") is not None:
            seen.setdefault("K2", ([a.clone() for a in args],
                                   {k: v.clone() for k, v in kw.items()}))
        return k2f(*args, **kw)

    holtslag.pbl_tridiag, emanuel.emanuel_mixing = k1_rec, k2_rec
    try:
        model.run_icbc(1)
    finally:
        holtslag.pbl_tridiag, emanuel.emanuel_mixing = k1f, k2f
    out = {}
    cases = []
    for k in ("K1", "K2"):
        if k not in seen:
            raise AssertionError(f"19a: E's cumulus step made no {k} "
                                 f"tracer call")
        cases.append((k, "E's operands", *((seen[k], {}) if k == "K1"
                                          else seen[k])))
    # E's operands must hold convection (a mass flux m > 0 in some
    # column, else the tracer form's contraction is of zeros); K2's
    # tracer form also takes phase 3's synthetic profiles, a deep cloud
    # in every column, at E's shape with seeded tracers
    ncol, L, ntr = seen["K2"][1]["tra"].shape
    rng = np.random.default_rng(12)
    nconv = int((seen["K2"][0][9] > 0.0).any(dim=1).sum())
    print(f"19a K2: {nconv} of {ncol} columns of E's cumulus step with a "
          f"mass flux")
    if nconv == 0:
        raise AssertionError("19a: E's cumulus step has no convecting "
                             "column, so K2's tracer form would be held on "
                             "zeros")
    cases.append(("K2", "clouds at E's shape",
                  k2_inputs((ncol, L), torch.float32, model.device),
                  {n: torch.as_tensor(rng.uniform(0.0, 1e-6, sh),
                                      dtype=torch.float32,
                                      device=model.device)
                   for n, sh in (("tra", (ncol, L, ntr)),
                                 ("trank", (ncol, ntr)))}))
    for k, label, args, kw in cases:
        mod = mods[k]
        kern = getattr(mod, NAMES[k])
        plain = getattr(mod, NAMES[k] + "_plain")
        for dtype in (torch.float32, torch.float64):
            cast = lambda a: a.to(dtype) if a.is_floating_point() else a
            a_ = [cast(a) for a in args]
            kw_ = {n: cast(v) for n, v in kw.items()}
            got = kern(*a_, **kw_)
            counts = {}
            want = plain(*a_, counts=counts, **kw_) if k == "K2" \
                else plain(*a_)
            torch.cuda.synchronize()
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            if k == "K2":
                rel, ab = rel_err(got["sum_tra"], want["sum_tra"])
                rel8 = max(rel_err(got[key], want[key])[0]
                           for key in mod.KEYS)
                if not rel8 <= max(tol, TOL[str(dtype).split(".")[-1]]["K2"]):
                    raise AssertionError(f"19a: K2's eight terms disagree "
                                         f"in the tracer form: {rel8}")
            else:
                rel, ab = rel_err(got, want)
            shape = tuple(args[3].shape) if k == "K1" \
                else tuple(kw["tra"].shape)
            print(f"19a {k} tracer call on {label} {shape} "
                  f"({dtype}): max rel err {rel:.3e} (max abs {ab:.3e}, tol "
                  f"{tol:g})")
            if not rel <= tol:
                raise AssertionError(f"19a: {k}'s tracer call disagrees with "
                                     f"its plain version: {rel}")
            if dtype == torch.float32:
                b_ms, b_by, byt, ops = tracer_bound(k, shape, 4, counts)
                st = dict(shape=list(shape), max_abs_err=ab, max_rel_err=rel,
                          ms=time_ms(lambda: kern(*a_, **kw_), D_REPS),
                          device_ms=device_ms(lambda: kern(*a_, **kw_),
                                              KERNELS[k], reps=D_REPS),
                          plain_ms=time_ms(lambda: plain(*a_, **kw_),
                                           D_REPS),
                          bound_ms=b_ms, bound_by=b_by, bytes=byt, ops=ops)
                print(f"19a {k} tracer call on {label} f32: kernel "
                      f"{st['ms']:.4f} ms (device {st['device_ms']:.4f} ms), "
                      f"plain {st['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}: {byt / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
                out.setdefault(k, {})[label] = st
    return out


def tracer_bound(k, shape, b, counts=None):
    """The bound of K1 at ns = ntr (``work``'s) and of K2's tracer form:
    K2's eight-term work plus tra in and sum_tra out (2 L ntr values a
    column) and trank; per valid pair the weights w1, w2c (4) and the
    ntr products and sums (2 ntr), per pair the mentc sum (1), per level
    and tracer the closing terms (4)."""
    if k == "K1":
        return bound("K1", shape, b)
    ncol, L, ntr = shape
    byt, ops = work("K2", (ncol, L), b, counts)
    byt += (2 * L * ntr + ntr) * ncol * b
    ops += ncol * L * L + counts["valid"] * (4 + 2 * ntr) + 4 * ncol * L * ntr
    t_b, t_o = byt / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            byt, ops)


def dust_test001(paths, device, idirect, dtype=None):
    """19b's model: test_001 from phase 13's files at noon (1990060112)
    with DUST and the land desert, a dust layer of 2e-5 kg/kg in levels
    10-13 as tests/test_chem.py's direct-effect test lays it."""
    import torch
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    cfg = chem_setup(hydro_icbc_cfg(), "DUST", idirect)
    cfg.restart.mdate1 = CHEM_NOON
    cfg.out.chemfrq = CHEM_EVERY * cfg.dtsec / 3600.0
    grid = desert(build_grid_from_domain(cfg, paths["domain"]))
    m = Model(cfg, grid=grid, device=device, dtype=dtype or torch.float32)
    m.init_from_icbc(ICBCReader(paths["hydro"], cfg.globdat.calendar))
    westerly(m)
    chi = m.state.chi_a.clone()
    chi[:, 10:14] = 2e-5 * m.state.ps_a[None, None]
    m.state = m.state._replace(chi_a=chi, chi_b=chi.clone())
    return m


def run_chem_b_f(dev, smi, paths, directory):
    """Phases 19b and 19f: the test_008 setting (DUST, idirect=2) on
    test_001 from phase 13's files for CHEM_STEPS steps at noon, with
    run_with_output writing CHE and OPT every CHEM_EVERY steps on NetCDF
    and then on Zarr (the stores equal record for record); the same run
    with idirect=0: the dust cuts the surface SW."""
    import torch
    from regcm_tpu_torch.io.ncio import read_nc
    from regcm_tpu_torch.io.zarrio import read_zarr
    sw = {}
    for run, idirect, backend in (("netcdf", 2, "netcdf"),
                                  ("zarr", 2, "zarr"), ("clean", 0, None)):
        m = dust_test001(paths, dev, idirect)
        t0 = time.time()
        if backend is None:
            m.run_icbc(CHEM_STEPS)
        else:
            m.open_output(os.path.join(directory, run), backend=backend)
            m.run_with_output(CHEM_STEPS)
            m.streams.close()
        torch.cuda.synchronize()
        if not m.check_finite():
            raise AssertionError(f"19b: non-finite ({run})")
        sw[run] = m.state.swsfc.cpu().numpy()
        print(f"19b {run} (idirect={idirect}): {CHEM_STEPS} steps in "
              f"{time.time() - t0:.2f} s, dust emitted "
              f"{float(m.state.chemdiag[0].sum()):.4e} kg/m2 summed over "
              f"the grid, max surface SW {sw[run].max():.2f} W/m2")
        del m
    day = sw["clean"] > 50.0
    cut = float((sw["clean"] - sw["netcdf"])[day].mean())
    print(f"19b surface SW at step {CHEM_STEPS}, idirect=0 minus idirect=2 "
          f"over {int(day.sum())} day points: {cut:.3f} W/m2 (tests/"
          f"test_chem.py:162 asks > 0.5) on {smi}")
    if not cut > 0.5:
        raise AssertionError(f"19b: the dust did not cut the surface SW: "
                             f"{cut}")
    for stream in ("CHE", "OPT"):
        fn = f"domain_{stream}.{CHEM_NOON // 100:08d}00"
        nc = read_nc(os.path.join(directory, "netcdf", fn + ".nc"))
        zr = read_zarr(os.path.join(directory, "zarr", fn + ".zarr"))
        nrec = len(nc["time"])
        if set(nc) != set(zr) or nrec != CHEM_STEPS // CHEM_EVERY + 1:
            raise AssertionError(f"19f {stream}: stores differ or "
                                 f"{nrec} records")
        for k, v in nc.items():
            if not np.array_equal(zr[k], v):
                raise AssertionError(f"19f {stream} {k}: the Zarr store "
                                     f"differs from the NetCDF file")
        print(f"19f {stream}: {nrec} records on NetCDF and Zarr, equal "
              f"record for record ({len(nc)} variables)")
        if stream == "OPT" and not float(nc["aod"][-1].max()) > 0.0:
            raise AssertionError("19f: zero aerosol optical depth")


def run_chem_moloch(dev, smi, paths, mods):
    """Phase 19c: the MOLOCH flagship with DUST from phase 13's ICBC file
    (10 m/s jet, the land desert) for CHEM_STEPS steps through K1 (twice a
    step), K2 (tracer form), K3 and K4 with the tracers in its stack (nf =
    5 + nqx + ntr = 11, counter and stack checked), and the ms/step."""
    import torch
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.dynamics import moloch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    cfg = chem_setup(flagship_cfg(), "DUST")
    cfg.globdat.gdate2 = ICBC_END
    model = Model(cfg, grid=desert(build_grid(cfg)), device=dev,
                  dtype=torch.float32)
    model.init_from_icbc(ICBCReader(paths["moloch"], cfg.globdat.calendar))
    westerly(model)
    seen = set()
    k4f = moloch.waf_advect

    def k4_rec(*args):
        seen.add(args[0].shape[0])
        return k4f(*args)
    moloch.waf_advect = k4_rec
    try:
        reset(mods)
        k2.launches_tracers = 0
        _, wall = model.run_icbc(CHEM_STEPS)
        launches = read(mods)
    finally:
        moloch.waf_advect = k4f
    print(f"19c. MOLOCH flagship with DUST ({cfg.dim.jx}x{cfg.dim.iy}x"
          f"{cfg.dim.kz}, f32, from ICBC): {CHEM_STEPS} steps, launches "
          f"{launches} (K2 {k2.launches_tracers} in the tracer form), K4's "
          f"stack nf {sorted(seen)}; ms/step (steps 0..{CHEM_STEPS - 1}, "
          f"radiation at 0, synchronised at the end) "
          f"{1000.0 * wall / CHEM_STEPS:.3f} on {smi}")
    if not model.check_finite():
        raise AssertionError("19c: non-finite MOLOCH state")
    if seen != {5 + model.core.nqx + model.core.ntr} \
            or launches["K4"] <= 0 or launches["K3"] <= 0 \
            or launches["K1"] != 2 * CHEM_STEPS \
            or k2.launches_tracers <= 0:
        raise AssertionError(f"19c: the chemistry path bypassed a kernel or "
                             f"K4 ran at nf {seen}: {launches}")
    print(f"19c step {CHEM_STEPS}: dust emitted "
          f"{float(model.state.chemdiag[0].sum()):.4e} kg/m2 summed over the "
          f"grid, max chi {float(model.state.chi_b.max()):.4e} kg/kg")
    del model
    torch.cuda.empty_cache()
    return dict(per_step_k1=launches["K1"] / CHEM_STEPS, nf=sorted(seen))


def _chem_cpu_run(name, conf=None, seed=None):
    """One of 19d's CPU runs (a spawned worker): the setting ``name`` at
    CHEM_CPU_SHAPE from the port's own start, perturbed with ``seed`` if
    given."""
    from tests import _torch_chem_settings as S
    S.SHAPE = CHEM_CPU_SHAPE
    start = S.port_start(name)
    if seed is not None:
        start = S.perturbed(name, start, seed)
    return S.port_run(name, start, conf=conf)


def start_chem_cpu(submit, names):
    """Submit 19d's CPU runs of the settings ``names`` (``submit``: a
    pool's submit; each plain, with the saturation adjustment off, and
    three seeds' spread runs)."""
    return {name: dict(cpu=submit(_chem_cpu_run, name),
                       cpu_dry=submit(_chem_cpu_run, name, 0.0),
                       spread=[submit(_chem_cpu_run, name, seed=seed)
                               for seed in range(3)])
            for name in names}


def chem_card_vs_cpu(dev, cpu=None):
    """Phase 19d: the CPU tests' chemistry settings (tests/
    _torch_chem_settings.py: the nine chemsimtypes on the hydrostatic
    core, AERO with E's physics, DUST with the direct effect and Grell's
    columns under cumtran; DUST on MOLOCH) at 16x20x14 on the card
    against the CPU in f64, 3 steps, held as phase 16c holds its
    settings: the spread rule with three seeds (a hydrometeor past it at
    most at 1% of the points), the dynamical fields with the saturation
    adjustment off to 1e-10. ``cpu``: the futures of start_chem_cpu, or
    None to run the CPU side here in a pool of its own."""
    from tests import _torch_chem_settings as S
    S.SHAPE = CHEM_CPU_SHAPE
    names = S.SIMS + ("dust_moloch",)
    if cpu is None:
        with cpu_pool() as pool:
            return chem_card_vs_cpu(dev, start_chem_cpu(pool.submit,
                                                        names))
    for name in names:
        s0 = S.port_start(name)
        runs = {"gpu": S.port_run(name, s0, device=dev),
                "gpu_dry": S.port_run(name, s0, device=dev, conf=0.0),
                "cpu": cpu[name]["cpu"].result(),
                "cpu_dry": cpu[name]["cpu_dry"].result()}
        spread = [f.result() for f in cpu[name]["spread"]]
        for r in runs.values():
            if not r["finite"]:
                raise AssertionError(f"19d {name}: non-finite")
        worst, flips = (0.0, ""), {}
        fields = runs["cpu"]["fields"]
        for f, want in fields.items():
            err = rel_rms(runs["gpu"]["fields"][f], want)
            lim = max(1e-7, 4.0 * max(rel_rms(p["fields"][f], want)
                                      for p in spread))
            worst = max(worst, (err / lim, f))
            if err < lim:
                continue
            off = np.abs(runs["gpu"]["fields"][f] - want) \
                > 1e-7 * np.abs(want).max()
            flips[f] = int(off.sum())
            if f != "qc" or off.mean() > 0.01:
                raise AssertionError(f"19d {name}: card and CPU "
                                     f"disagree on {f}: rel-RMS {err} "
                                     f"(bound {lim})")
        dyn = [f for f in ("ps", "t", "qv", "u", "v", "w") if f in fields]
        dry = max((rel_rms(runs["gpu_dry"]["fields"][f],
                           runs["cpu_dry"]["fields"][f]), f) for f in dyn)
        print(f"19d {name}, 3 steps f64 16x20x14, card vs CPU: worst "
              f"field {worst[1]} at {worst[0]:.3f} of its bound"
              + (f"; points past 1e-7 by a branch flip {flips}" if flips
                 else "") + f"; saturation adjustment off: worst "
              f"{dry[1]} rel-RMS {dry[0]:.3e} (bound 1e-10)")
        if not dry[0] <= 1e-10:
            raise AssertionError(f"19d {name}: card and CPU disagree "
                                 f"with the adjustment off on {dry[1]}: "
                                 f"{dry[0]}")


def chem_single(dev, paths):
    """19e's single-card reference: E's settings on test_001's widths
    from phase 13's files, E_CHECK steps, the whole domain's fields."""
    import torch
    model = e_model(paths, dev, files="test_001")
    model.run_icbc(E_CHECK)
    out = chem_fields(model)
    del model
    torch.cuda.empty_cache()
    return out


def chem_rank(rank, paths):
    """Phase 19e on one rank of the 2x2 group: E's settings on test_001's
    widths for E_CHECK steps (counters and halo tallies reset just
    before, read just after); the whole domain's fields (on rank 0)."""
    import torch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.parallel import halo
    mods = {"K1": k1, "K2": k2}
    model = e_model(paths, rank.device, rank.mesh(34, 48), files="test_001")
    reset(mods)
    k1.launches_sharded = k2.launches_tracers = 0
    halo.exchanges = halo.bytes_sent = 0
    model.run_icbc(E_CHECK)
    launches = read(mods)
    launches.update(K5c=k1.launches_sharded, K2_tracers=k2.launches_tracers)
    out = dict(launches=launches, finite=model.check_finite(),
               exchanges_per_step=halo.exchanges / E_CHECK,
               bytes_per_step=halo.bytes_sent / E_CHECK)
    dec = chem_fields(model)
    out["dec"] = dec if rank.rank == 0 else None
    del model
    torch.cuda.empty_cache()
    return out


def check_chem_decomposed(res, backend, e19):
    """19e's checks of the 2x2 group's chemistry run against one card:
    every field bit for bit at E_CHECK, K5c twice a step (Holtslag's
    fields and the tracers), K2 in its tracer form."""
    for r, out in enumerate(res):
        h = out["chem"]
        print(f"  rank {r} configuration E on test_001's widths: launches "
              f"{h['launches']}, {h['exchanges_per_step']:.1f} halo "
              f"exchanges and {h['bytes_per_step'] / 1e6:.3f} MB sent a step")
        if not h["finite"]:
            raise AssertionError(f"rank {r}: non-finite decomposed E")
        lau = h["launches"]
        if lau["K5c"] != 2 * E_CHECK or lau["K1"] != 0 \
                or lau["K2_tracers"] <= 0:
            raise AssertionError(f"rank {r} ({backend}): the decomposed "
                                 f"chemistry bypassed K5c or K2's tracer "
                                 f"form: {lau}")
    dec = res[0]["chem"]["dec"]
    for f, want in e19.items():
        same = np.array_equal(dec[f], want)
        print(f"  configuration E f32 34x48x18 step {E_CHECK}, {backend} 2x2 "
              f"vs one card (19e), {f}: "
              f"{'bit-identical' if same else 'DIFFERENT'}, rel-RMS "
              f"{rel_rms(dec[f], want):.3e}")
        if not same:
            raise AssertionError(f"decomposed configuration E ({backend}) "
                                 f"differs from one card in {f}")




# -- phase 20: the gas-phase chemistry ---------------------------------------
def write_chbc(cfg, grid, path, sim):
    """A CHBC file (the port's chem_icbc climatology) of chemsimtype
    ``sim`` on ``grid``, over the first F_CHBC_HOURS of ``cfg``'s ICBC
    window (two records a run of a few steps reads)."""
    import copy
    from regcm_tpu_torch.preproc.chem_icbc import generate_chem_icbc
    c = copy.deepcopy(cfg)
    c.chem.chemsimtype = sim
    c.globdat.gdate2 = c.globdat.gdate1 + F_CHBC_HOURS
    return generate_chem_icbc(c, path, xlat=np.asarray(grid.xlat))


def write_gas_files(directory):
    """Phase 20's CHBC files: DCCB on D's band grid (F), CBMZ and CB6 on
    test_001's grid (20b, 20d), beside the DOMAIN and ICBC files of
    phases 13 and 17."""
    from regcm_tpu_torch.core.grid import build_grid
    paths = {}
    band = build_grid(band_cfg())
    paths["chbc_F"] = write_chbc(band_cfg(), band,
                                 os.path.join(directory, "F_CHBC.nc"), F_SIM)
    hgrid = build_grid(hydro_icbc_cfg())
    for sim in ("CBMZ", "CB6"):
        paths[f"chbc_{sim}"] = write_chbc(
            hydro_icbc_cfg(), hgrid,
            os.path.join(directory, f"test_001_{sim}_CHBC.nc"), sim)
    return paths


def chbc_start(model, reader):
    """The tracers of ``model`` (both time levels) set to the CHBC record
    at its date (the rank's block under a mesh), coupled to p*."""
    rec, _ = reader.record_at(model.date)
    chi = model._block(model._host(rec)) * model.state.ps_a[None, None]
    model.state = model.state._replace(chi_a=chi, chi_b=chi.clone())
    return model


def gas_model(paths, device, sim, mesh=None, dtype=None, files="test_001",
              physics=None):
    """A chemistry model from the DOMAIN and ICBC files of phase 17
    (``files="band"``: configuration F, D's physics with ``sim``, started
    moistened as E) or of phase 13 (test_001's widths, with ``physics``),
    the land desert, a westerly added; with a CHBC file for ``sim`` where
    phase 20 wrote one (``set_chem_bc``; the tracers start from its
    record, NH3 seeded for the SNA aerosol), else AERO's carbon and
    sulfur seeded."""
    import torch
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.chem_icbc import CHBCReader
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    if files == "band":
        cfg, dom, icbc = band_cfg(), paths["band_domain"], paths["band"]
    else:
        cfg = with_physics(hydro_icbc_cfg(), physics or {})
        dom, icbc = paths["domain"], paths["hydro"]
    cfg = chem_setup(cfg, sim)
    cfg.tiedtke.lmfsmooth = True
    grid = desert(build_grid_from_domain(cfg, dom))
    m = Model(cfg, grid=grid, device=device, dtype=dtype or torch.float32,
              mesh=mesh)
    m.init_from_icbc(ICBCReader(icbc, cfg.globdat.calendar))
    if files == "band":
        # D's state after F_SPINUP steps of E's start, the tracers F's own
        spun = f_spinup(paths, device, mesh)
        chem = ("chi_a", "chi_b", "chemdiag")
        m.state = m.state._replace(**{
            k: getattr(spun, k).to(getattr(m.state, k).dtype)
            for k in m.state._fields
            if k not in chem and getattr(m.state, k) is not None})
    else:
        m = westerly(m)
        if 5 in (cfg.physics.icup_lnd, cfg.physics.icup_ocn):
            m.state = moisten(m.state, m.idynamic, E_QVFAC)
    key = f"chbc_{'F' if files == 'band' else sim}"
    if key in paths:
        reader = CHBCReader(paths[key], cfg.globdat.calendar)
        m.set_chem_bc(reader)
        m = chbc_start(m, reader)
        names = m.core.physics.chem.spec.names
        for name, peak in F_SEEDED.items():
            if name in names:
                m = seed_tracers(m, [names.index(name)], peak)
    else:
        m = seed_tracers(m, E_SEEDED)
    return m


def f_spinup(paths, device, mesh=None):
    """F's warm start: the state of D's physics after F_SPINUP steps from
    E's start (phase 17's files, the westerly, qv E_QVFAC times the
    files'), without the chemistry; from the cold start Emanuel's columns
    convect first at its third call, step 4."""
    m = band_model(paths, device, mesh)
    m = westerly(m)
    m.state = moisten(m.state, m.idynamic, E_QVFAC)
    m.run_icbc(F_SPINUP)
    state = m.state
    del m
    return state


class TimedGas:
    """A gas-phase driver (``ChemTend.cbmz``) whose calls are timed,
    synchronised around each."""

    def __init__(self, drv):
        self.drv, self.ms = drv, []

    def __call__(self, *args):
        import torch
        torch.cuda.synchronize()
        t0 = time.time()
        out = self.drv(*args)
        torch.cuda.synchronize()
        self.ms.append(1e3 * (time.time() - t0))
        return out


def tracer_of(model, name):
    """Tracer ``name``'s mixing ratio (kg/kg) of the whole domain."""
    s = model.state
    n = model.core.physics.chem.spec.names.index(name)
    chi = s.chi_b[n] if model.idynamic == 3 else s.chi_a[n] / s.ps_a[None]
    if model.mesh is not None:
        chi = model.mesh.gather(chi)
    return chi.double().cpu().numpy()


def gas_stats(drv, timed, what, smi):
    """Print and return the gas solver's ms, Ros2 iterations and host syncs
    a call."""
    from regcm_tpu_torch.chem import kinetics
    st, n = drv.stats, max(len(timed.ms), 1)
    out = dict(calls=len(timed.ms), ms=sum(timed.ms) / n,
               iterations=st.get("iterations", 0) / n,
               syncs=st.get("syncs", 0) / n,
               solves=st.get("solves", 0) / n)
    print(f"{what} gas solver: {out['calls']} calls, {out['ms']:.1f} ms a "
          f"call, {out['iterations']:.1f} Ros2 iterations, "
          f"{out['syncs']:.1f} host syncs and {out['solves']:.1f} solves "
          f"of {kinetics.CUDA_CHUNK}-cell chunks a call (synchronised, on "
          f"{smi})")
    return out


def run_chem_f(dev, smi, paths, mods):
    """Phase 20a: configuration F (E plus the gas phase: DCCB) at full
    width from phase 17's files and its CHBC file for F_STEPS steps: the
    launches (K1 twice a step, K2's tracer form on the cumulus steps, K6 a
    factorisation and a solve each Ros2 iteration), the ms of each step
    class and of the gas solver a call, its iterations and host syncs, the
    peak memory; ozone moves, the SNA aerosol forms, the boundary holds
    the CHBC records; then K1 (ns = ntr), K2's tracer form (ntr = 50) and
    K6 against their plain versions on F's own operands, recorded in the
    main path's run, and timed."""
    import torch
    from regcm_tpu_torch.chem import kinetics
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import gas_lu as k6
    from regcm_tpu_torch.physics.cumulus import emanuel
    from regcm_tpu_torch.physics.pbl import holtslag
    t0 = time.time()
    model = gas_model(paths, dev, F_SIM, files="band")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    g = model.grid
    shape = f"{g.jx}x{g.iy}x{g.kz}"
    ntr = model.core.ntr
    chem = model.core.physics.chem
    timed = TimedGas(chem.cbmz)
    chem.cbmz = timed
    print(f"20a. configuration F = E plus the gas phase ({F_SIM}: {ntr} "
          f"tracers), the tropical band at {shape} (ds {model.cfg.geo.ds} "
          f"km, dt {model.cfg.dtsec} s, f32, from ICBC moistened, the "
          f"tracers from the CHBC record, NH3 seeded; set-up "
          f"{time.time() - t0:.1f} s)")
    o3_0, anh4_0, ano3_0 = (tracer_of(model, n)
                            for n in ("O3", "ANH4", "ANO3"))
    chb0 = model.bdy.chi0
    seen = {}
    k1f, k2f, k6f = holtslag.pbl_tridiag, emanuel.emanuel_mixing, \
        kinetics.lu_factor_solve

    def k1_rec(*args):
        if args[3].shape[0] == ntr:
            seen.setdefault("K1", [a.clone() for a in args])
        return k1f(*args)

    def k2_rec(*args, **kw):
        if kw.get("tra") is not None:       # the last cumulus step's
            seen["K2"] = ([a.clone() for a in args],
                          {k: v.clone() for k, v in kw.items()})
        return k2f(*args, **kw)

    def k6_rec(p, b):
        seen["K6_calls"] = seen.get("K6_calls", 0) + 1
        if seen["K6_calls"] == F_K6_CALL:
            seen["K6"] = (p.clone(), b.clone())
        return k6f(p, b)

    holtslag.pbl_tridiag, emanuel.emanuel_mixing = k1_rec, k2_rec
    kinetics.lu_factor_solve = k6_rec
    try:
        reset(mods)
        k2.launches_tracers = k6.launches = k6.launches_solve = 0
        rows, _ = timed_steps(model, F_STEPS)
        launches = read(mods)
        launches.update(K2_tracers=k2.launches_tracers, K6a=k6.launches,
                        K6b=k6.launches_solve)
    finally:
        holtslag.pbl_tridiag, emanuel.emanuel_mixing = k1f, k2f
        kinetics.lu_factor_solve = k6f
    ncum = sum(1 for row in rows if row[3])
    print(f"20a path: {F_STEPS} steps, launches {launches} ({ncum} cumulus "
          f"steps)")
    if not model.check_finite():
        raise AssertionError("20a: non-finite state")
    if launches["K1"] != 2 * F_STEPS or launches["K2_tracers"] != ncum \
            or ncum == 0 or launches["K6a"] <= 0 \
            or launches["K6b"] != launches["K6a"]:
        raise AssertionError(f"20a bypassed K1's tracer solve, K2's tracer "
                             f"form or K6: {launches}")
    ms = class_ms(rows, "20a", smi, shape, first=0)
    gas = gas_stats(timed.drv, timed, "20a", smi)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"20a peak device memory {peak:.2f} GiB on {smi}")
    o3, anh4, ano3 = (tracer_of(model, n) for n in ("O3", "ANH4", "ANO3"))
    do3 = float(np.max(np.abs(o3 / np.maximum(o3_0, 1e-30) - 1.0)))
    form = {"ANH4": float((anh4 - anh4_0).max()),
            "ANO3": float((ano3 - ano3_0).max())}
    print(f"20a step {F_STEPS}: O3 moved by up to {100 * do3:.2f}% of "
          f"itself; the SNA aerosol formed by up to {form} kg/kg (ANH4 "
          f"{anh4_0.sum():.4e} -> {anh4.sum():.4e}, ANO3 {ano3_0.sum():.4e} "
          f"-> {ano3.sum():.4e} kg/kg summed over the grid)")
    if not (do3 > 0.01 and min(form.values()) > 0.0):
        raise AssertionError("20a: ozone did not move or the SNA aerosol "
                             "did not form")
    # the lateral boundary: the band's northern ring row holds the CHBC
    # records, not clean air (zero); row 0, the southern ring and flow
    # edge, takes 0 where air flows in and the interior's where it flows
    # out (chibdyflow, as the JAX package's)
    io3 = chem.spec.names.index("O3")
    want = (chb0[io3] / model.bdy.ps0[None]).double().cpu().numpy()[:, -1]
    held = np.abs(o3[:, -1] - want) <= 1e-3 * np.abs(want)
    print(f"20a the northern ring's O3: {100 * held.mean():.1f}% of its "
          f"points hold the CHBC records (mean {want.mean():.4e} kg/kg; "
          f"clean air would be 0); the southern flow edge's mean "
          f"{o3[:, 0].mean():.4e} kg/kg")
    if not (want.mean() > 0.0 and held.mean() > 0.99):
        raise AssertionError("20a: the boundary does not hold the CHBC "
                             "records")
    nconv = int((seen["K2"][0][9] > 0.0).any(dim=1).sum())
    print(f"20a K2: {nconv} of {seen['K2'][0][0].shape[0]} columns of F's "
          f"last cumulus step with a mass flux")
    if nconv == 0:
        raise AssertionError("20a: F's last cumulus step has no convecting "
                             "column, so K2's tracer form would be held on "
                             "zeros")
    operands = check_f_operands(seen, mods)
    del model, seen
    torch.cuda.empty_cache()
    return dict(ms=ms, gas=gas, peak_gib=peak, launches=launches,
                per_step=dict(K1=launches["K1"] / F_STEPS,
                              K2=launches["K2_tracers"] / ncum),
                operands=operands)


def k6_bound(shape, b):
    """K6's bound: the factorisation and its first solve read P and b and
    write the LU, the pivots and x (2 N² + 3 N values a cell); about
    2/3 N³ operations for the elimination (N(N−1)/2 quotients and
    N(N−1)(2N−1)/3 products and differences) and 2 N² for the two
    triangular sweeps. The second solve reads the LU, the pivots and b and
    writes x (N² + 3 N values, 2 N² operations)."""
    ncell, n = shape
    lu_ops = n * (n - 1) / 2 + n * (n - 1) * (2 * n - 1) / 3
    out = {}
    for k, byt, ops in (("K6a", (2 * n * n + 3 * n) * b, lu_ops + 2 * n * n),
                        ("K6b", (n * n + 3 * n) * b, 2 * n * n)):
        t_b, t_o = ncell * byt / HBM_BYTES_PER_S, ncell * ops / F32_FLOPS
        out[k] = (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o
                  else "operations", ncell * byt, ncell * ops)
    return out


def check_f_operands(seen, mods):
    """20a's kernels on F's own operands, recorded in its run: K1's tracer
    call (ns = ntr) and K2's tracer form against their plain versions in
    f32 (1e-5) and f64 (1e-12; K2's eight terms at their 1e-10), and K6
    (the F_K6_CALL-th factorisation, one chunk's stage matrices) and its
    second solve against the plain torch.linalg.lu_factor/lu_solve, f32
    at 1e-5 and f64 at 1e-12 of the solution's scale; each timed in f32
    with its device time beside its bound."""
    import torch
    from regcm_tpu_torch.kernels import gas_lu as k6
    out = {}
    for k in ("K1", "K2"):
        mod = mods[k]
        args, kw = (seen[k], {}) if k == "K1" else seen[k]
        kern, plain = getattr(mod, NAMES[k]), getattr(mod, NAMES[k] + "_plain")
        for dtype in (torch.float32, torch.float64):
            cast = lambda a: a.to(dtype) if a.is_floating_point() else a
            a_ = [cast(a) for a in args]
            kw_ = {n: cast(v) for n, v in kw.items()}
            got = kern(*a_, **kw_)
            counts = {}
            want = plain(*a_, counts=counts, **kw_) if k == "K2" \
                else plain(*a_)
            torch.cuda.synchronize()
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            if k == "K2":
                rel, ab = rel_err(got["sum_tra"], want["sum_tra"])
                rel8 = max(rel_err(got[key], want[key])[0]
                           for key in mod.KEYS)
                if not rel8 <= max(tol, TOL[str(dtype).split(".")[-1]]["K2"]):
                    raise AssertionError(f"20a: K2's eight terms disagree "
                                         f"in the tracer form: {rel8}")
                shape = tuple(kw["tra"].shape)
            else:
                rel, ab = rel_err(got, want)
                shape = tuple(args[3].shape)
            big = float((want["sum_tra"] if k == "K2" else want).abs().max())
            print(f"20a {k} tracer call on F's operands {shape} ({dtype}): "
                  f"max rel err {rel:.3e} (max abs {ab:.3e}, largest "
                  f"output {big:.3e}, tol {tol:g})")
            if not big > 0.0:
                raise AssertionError(f"20a: {k} held on zeros")
            if not rel <= tol:
                raise AssertionError(f"20a: {k}'s tracer call disagrees with "
                                     f"its plain version: {rel}")
            if dtype == torch.float32:
                b_ms, b_by, byt, ops = tracer_bound(k, shape, 4, counts)
                out[k] = dict(
                    shape=list(shape), max_abs_err=ab, max_rel_err=rel,
                    ms=time_ms(lambda: kern(*a_, **kw_), D_REPS),
                    device_ms=device_ms(lambda: kern(*a_, **kw_), KERNELS[k],
                                        reps=D_REPS),
                    plain_ms=time_ms(lambda: plain(*a_, **kw_), D_REPS),
                    bound_ms=b_ms, bound_by=b_by, bytes=byt, ops=ops)
                print(f"20a {k} tracer call on F's operands f32: kernel "
                      f"{out[k]['ms']:.4f} ms (device "
                      f"{out[k]['device_ms']:.4f} ms), plain "
                      f"{out[k]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
                      f"({b_by}: {byt / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    p32, b32 = seen["K6"]
    rng = np.random.default_rng(20)
    for dtype in (torch.float32, torch.float64):
        p, b = p32.to(dtype), b32.to(dtype)
        b2 = b * torch.as_tensor(rng.uniform(0.5, 1.5, tuple(b.shape)),
                                 dtype=dtype, device=b.device)
        lu_w, piv_w, x_w = k6.lu_factor_solve_plain(p, b)
        y_w = k6.lu_solve_plain(lu_w, piv_w, b2)
        lu, piv, x = k6.lu_factor_solve(p.clone(), b)
        y = k6.lu_solve(lu, piv, b2)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        rel = max(rel_err(x, x_w)[0], rel_err(y, y_w)[0])
        same = bool(torch.equal(piv.long() + 1, piv_w.long()))
        print(f"20a K6 on F's stage matrices {tuple(p.shape)} ({dtype}): "
              f"max rel err of the solves {rel:.3e} (tol {tol:g}), the "
              f"plain version's pivots {'kept' if same else 'NOT kept'}")
        if not rel <= tol:
            raise AssertionError(f"20a: K6 disagrees with its plain version: "
                                 f"{rel}")
        if dtype == torch.float32:
            bnd = k6_bound(tuple(b.shape), 4)
            pc = p.clone()
            for k, fn, kern_names, pl in (
                    ("K6a", lambda: k6.lu_factor_solve(pc, b),
                     ("lu_factor_solve_kernel",),
                     lambda: k6.lu_factor_solve_plain(p, b)),
                    ("K6b", lambda: k6.lu_solve(lu, piv, b2),
                     ("lu_solve_kernel",),
                     lambda: k6.lu_solve_plain(lu_w, piv_w, b2))):
                b_ms, b_by, byt, ops = bnd[k]
                st = dict(shape=list(p.shape), max_abs_err=max(
                    rel_err(x, x_w)[1], rel_err(y, y_w)[1]),
                    max_rel_err=rel, ms=time_ms(fn, D_REPS),
                    device_ms=device_ms(fn, kern_names, reps=D_REPS),
                    plain_ms=time_ms(pl, D_REPS), bound_ms=b_ms,
                    bound_by=b_by, bytes=byt, ops=ops)
                st["library_ms"] = st["plain_ms"]
                out[k] = st
                print(f"20a {k} on F's stage matrices f32: kernel "
                      f"{st['ms']:.4f} ms (device {st['device_ms']:.4f} ms), "
                      f"plain (torch.linalg) {st['plain_ms']:.4f} ms, bound "
                      f"{b_ms:.4f} ms ({b_by}: {byt / 1e6:.1f} MB, "
                      f"{ops / 1e9:.3f} GFLOP)")
    return out


def run_gas_settings(dev, smi, paths, mods):
    """Phase 20b: at test_001's widths from phase 13's files, GAS_STEPS
    steps each: AERO under Tiedtke over both surfaces with lmfsmooth and
    ichcumtra=1 (ctracer on the cumulus steps; K1 twice a step), CBMZ and
    CB6 with their CHBC files (K6 every step)."""
    import torch
    from regcm_tpu_torch.kernels import gas_lu as k6
    from regcm_tpu_torch.physics import suite
    for label, sim, physics in (("Tiedtke + AERO", "AERO", GAS_TIEDTKE),
                                ("CBMZ", "CBMZ", {}), ("CB6", "CB6", {})):
        model = gas_model(paths, dev, sim, physics=physics)
        chem = model.core.physics.chem
        timed = None
        if chem.cbmz is not None:
            timed = TimedGas(chem.cbmz)
            chem.cbmz = timed
        ct = []
        ctf = suite.ctracer

        def ct_rec(*args):
            ct.append(int(args[1].ct_ldcum.sum()))
            return ctf(*args)
        suite.ctracer = ct_rec
        try:
            reset(mods)
            k6.launches = 0
            t0 = time.time()
            model.run_icbc(GAS_STEPS)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = read(mods)
        finally:
            suite.ctracer = ctf
        launches["K6a"] = k6.launches
        print(f"20b. {label} on test_001 ({model.grid.jx}x{model.grid.iy}x"
              f"{model.grid.kz}, f32, from ICBC): {GAS_STEPS} steps in "
              f"{wall:.2f} s, launches {launches}"
              + (f"; ctracer on {len(ct)} cumulus steps, {ct} columns "
                 f"transporting" if ct else ""))
        if not model.check_finite():
            raise AssertionError(f"20b {label}: non-finite state")
        if launches["K1"] != 2 * GAS_STEPS:
            raise AssertionError(f"20b {label}: the tracers' K1 solve was "
                                 f"bypassed: {launches}")
        if sim == "AERO" and not (ct and max(ct) > 0):
            raise AssertionError("20b: Tiedtke's ctracer moved no column")
        if timed is not None:
            gas_stats(timed.drv, timed, f"20b {label}", smi)
            o3 = "OZN" if sim == "CB6" else "O3"
            if launches["K6a"] <= 0 or model.bdy.chi0 is None:
                raise AssertionError(f"20b {label}: K6 or the CHBC pair "
                                     f"missing: {launches}")
            print(f"20b {label}: {o3} max {tracer_of(model, o3).max():.4e} "
                  f"kg/kg")
        del model
        torch.cuda.empty_cache()


def _gas_cpu_run(name, conf=None, seed=None):
    """One of 20c's CPU runs (a spawned worker): the setting ``name`` of
    the CPU tests from the port's own start, perturbed with ``seed`` if
    given."""
    S = gas_settings()
    start = S.port_start(name)
    if seed is not None:
        start = S.perturbed(name, start, seed)
    return S.port_run(name, start, conf=conf)


def start_gas_cpu(submit):
    """Submit 20c's CPU runs (``submit``: a pool's submit; each setting
    plain, with the saturation adjustment off, and three seeds' spread
    runs)."""
    from tests import _torch_chem_settings as S
    return {name: dict(cpu=submit(_gas_cpu_run, name),
                       cpu_dry=submit(_gas_cpu_run, name, 0.0),
                       spread=[submit(_gas_cpu_run, name, seed=seed)
                               for seed in range(3)])
            for name in S.GAS}


def gas_card_vs_cpu(dev, cpu):
    """Phase 20c: the CPU tests' gas-phase settings (tests/
    _torch_chem_settings.py: CBMZ and CB6, DCCB with F's physics, AERO
    under Tiedtke with lmfsmooth, CBMZ on MOLOCH) at GAS_CPU_SHAPE on the card
    against the CPU in f64, 3 steps: the spread rule with three seeds,
    the dynamical fields with the saturation adjustment off to
    1e-10. The CPU runs (``cpu``, from start_gas_cpu) ran in a pool of
    spawned processes while the card ran the phases before."""
    S = gas_settings()
    for name in S.GAS:
        s0 = S.port_start(name)
        runs = {"gpu": S.port_run(name, s0, device=dev),
                "gpu_dry": S.port_run(name, s0, device=dev, conf=0.0),
                "cpu": cpu[name]["cpu"].result(),
                "cpu_dry": cpu[name]["cpu_dry"].result()}
        spread = [f.result() for f in cpu[name]["spread"]]
        for r in runs.values():
            if not r["finite"]:
                raise AssertionError(f"20c {name}: non-finite")
        worst = (0.0, "")
        fields = runs["cpu"]["fields"]
        for f, want in fields.items():
            got = runs["gpu"]["fields"][f]
            if not want.any():
                # zero on the CPU (the MOLOCH setting's large-scale rain):
                # the card's roundoff-sized values (2e-22 mm) pass
                if np.abs(got).max() > S.ZERO_FLOOR:
                    raise AssertionError(f"20c {name}: {f} is zero on the "
                                         f"CPU, up to {np.abs(got).max()} "
                                         f"on the card")
                continue
            err = rel_rms(got, want)
            lim = max(1e-7, 4.0 * max(rel_rms(p["fields"][f], want)
                                      for p in spread))
            worst = max(worst, (err / lim, f))
            if not err < lim:
                raise AssertionError(f"20c {name}: card and CPU disagree on "
                                     f"{f}: rel-RMS {err} (bound {lim})")
        dyn = [f for f in ("ps", "t", "qv", "u", "v", "w") if f in fields]
        dry = max((rel_rms(runs["gpu_dry"]["fields"][f],
                           runs["cpu_dry"]["fields"][f]), f) for f in dyn)
        print(f"20c {name}, 3 steps f64 "
              f"{S.SETTINGS[name].get('shape', S.SHAPE)}, card vs "
              f"CPU: worst field {worst[1]} at {worst[0]:.3f} of its bound"
              f"; saturation adjustment off: worst {dry[1]} "
              f"rel-RMS {dry[0]:.3e} (bound 1e-10)")
        if not dry[0] <= 1e-10:
            raise AssertionError(f"20c {name}: card and CPU disagree with "
                                 f"the adjustment off on {dry[1]}: {dry[0]}")


def gas_single(dev, paths):
    """20d's single-card reference: CBMZ on test_001's widths from phase
    13's files with its CHBC file, GAS_CHECK steps, the whole domain's
    fields."""
    import torch
    model = gas_model(paths, dev, "CBMZ")
    model.run_icbc(GAS_CHECK)
    out = chem_fields(model)
    del model
    torch.cuda.empty_cache()
    return out


def gas_rank(rank, paths):
    """Phase 20d on one rank of the 2x2 group: CBMZ on test_001's widths
    for GAS_CHECK steps (counters and halo tallies reset just before, read
    just after); the whole domain's fields (on rank 0)."""
    import torch
    from regcm_tpu_torch.kernels import gas_lu as k6
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.parallel import halo
    model = gas_model(paths, rank.device, "CBMZ", mesh=rank.mesh(34, 48))
    k1.launches = k1.launches_sharded = k6.launches = 0
    halo.exchanges = halo.bytes_sent = 0
    model.run_icbc(GAS_CHECK)
    out = dict(launches=dict(K1=k1.launches, K5c=k1.launches_sharded,
                             K6a=k6.launches),
               finite=model.check_finite(),
               exchanges_per_step=halo.exchanges / GAS_CHECK,
               bytes_per_step=halo.bytes_sent / GAS_CHECK)
    dec = chem_fields(model)
    out["dec"] = dec if rank.rank == 0 else None
    del model
    torch.cuda.empty_cache()
    return out


def check_gas_decomposed(res, backend, g20):
    """20d's checks of the 2x2 group's CBMZ run against one card: every
    field bit for bit at GAS_CHECK, K5c twice a step, K6 on every rank."""
    for r, out in enumerate(res):
        h = out["gas"]
        print(f"  rank {r} CBMZ on test_001's widths: launches "
              f"{h['launches']}, {h['exchanges_per_step']:.1f} halo "
              f"exchanges and {h['bytes_per_step'] / 1e6:.3f} MB sent a step")
        if not h["finite"]:
            raise AssertionError(f"rank {r}: non-finite decomposed CBMZ")
        lau = h["launches"]
        if lau["K5c"] != 2 * GAS_CHECK or lau["K1"] != 0 or lau["K6a"] <= 0:
            raise AssertionError(f"rank {r} ({backend}): the decomposed gas "
                                 f"phase bypassed K5c or K6: {lau}")
    dec = res[0]["gas"]["dec"]
    for f, want in g20.items():
        same = np.array_equal(dec[f], want)
        print(f"  CBMZ f32 34x48x18 step {GAS_CHECK}, {backend} 2x2 vs one "
              f"card (20d), {f}: {'bit-identical' if same else 'DIFFERENT'}"
              f", rel-RMS {rel_rms(dec[f], want):.3e}")
        if not same:
            raise AssertionError(f"decomposed CBMZ ({backend}) differs from "
                                 f"one card in {f}")


def run_gas_phase(dev, smi, paths, mods, directory, cpu=None):
    """Phases 20a-c and 20d's single-card reference; ``cpu``: the futures
    of start_gas_cpu, or None to run 20c's CPU side in a pool of its own
    from the phase's start."""
    if cpu is None:
        with cpu_pool() as pool:
            return run_gas_phase(dev, smi, paths, mods, directory,
                                 start_gas_cpu(pool.submit))
    t20 = time.time()
    paths.update(write_gas_files(directory))
    print(f"20: CHBC files written in {time.time() - t20:.1f} s")
    f20 = run_chem_f(dev, smi, paths, mods)
    stamp("20b")
    run_gas_settings(dev, smi, paths, mods)
    stamp("20c")
    gas_card_vs_cpu(dev, cpu)
    g20 = gas_single(dev, paths)
    print(f"phase 20a-c took {time.time() - t20:.1f} s")
    return f20, g20


def run(pools):
    """The phases; the CPU pool it starts goes into ``pools``."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check runs only on a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from regcm_tpu_torch.config.params import RegCMConfig
        from regcm_tpu_torch.core.grid import build_grid
        from regcm_tpu_torch.driver import Model, standard_atmosphere_state
        from regcm_tpu_torch.dynamics.moloch import MolochCore
        from regcm_tpu_torch.kernels import emanuel_mixing as k2
        from regcm_tpu_torch.kernels import pbl_tridiag as k1
        from regcm_tpu_torch.kernels import tridiag_w as k3
        from regcm_tpu_torch.kernels import waf_advect as k4
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the repository is not here ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mods = {"K1": k1, "K2": k2, "K3": k3, "K4": k4}
    t_all = _T0[0] = time.time()
    pools.append(cpu_pool())
    cpu = start_cpu_refs(pools[0])

    # -- 1. card and versions
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {kind}")

    # -- 2. build: one nvcc per source, all at once (nvcc runs in a
    # subprocess, so the threads overlap)
    from concurrent.futures import ThreadPoolExecutor
    from regcm_tpu_torch.kernels import gas_lu as k6
    t0 = time.time()
    builds = list(mods.values()) + [k6]
    with ThreadPoolExecutor(len(builds)) as ex:
        for fut in [ex.submit(m.build) for m in builds]:
            fut.result()
    print(f"kernels built in {time.time() - t0:.1f} s")

    # -- 3. kernels against their plain versions
    stats = compare_kernels(dev, mods)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    stamp('4. hydrostatic path')
    # -- 4. hydrostatic path: test_001 full physics, f32, 24 steps
    cfg = RegCMConfig()
    grid = build_grid(cfg)
    print(f"hydrostatic model: {grid.jx}x{grid.iy}x{grid.kz}, dt "
          f"{cfg.dtsec} s, ds {cfg.geo.ds} km")
    s0 = standard_atmosphere_state(grid, cfg, dev, torch.float32,
                                   perturb=0.3, seed=1)
    model = Model(cfg, grid=grid, device=dev, dtype=torch.float32,
                  initial_state=s0)
    reset(mods)
    _, wall = model.run(STEPS)
    hydro_launches = read(mods)
    print(f"hydrostatic path: {STEPS} steps in {wall:.3f} s; launches "
          f"{hydro_launches}")
    if not model.check_finite():
        raise AssertionError("non-finite state after the f32 run")
    if hydro_launches["K1"] <= 0 or hydro_launches["K2"] <= 0:
        raise AssertionError(f"hydrostatic path bypassed a kernel: "
                             f"{hydro_launches}")
    d = model.decoupled()
    print(f"ps {d['ps'].min():.3f}..{d['ps'].max():.3f} hPa, "
          f"T {d['t'].min():.3f}..{d['t'].max():.3f} K")
    _, wall = model.run(STEPS)
    print(f"hydrostatic ms/step (f32, steps {STEPS}..{2 * STEPS - 1}, "
          f"synchronised): {1000.0 * wall / STEPS:.3f} on {smi}")
    del model, s0

    stamp('5. hydrostatic card against CPU')
    # -- 5. hydrostatic card against CPU, f64, 10 steps. From the rest
    # state the saturation adjustment amplifies roundoff (a 1e-15 change
    # of T moves u, v by ~5e-7), so the default run is held to four times
    # that measured spread; with the adjustment off (subexparam conf=0)
    # the trajectory is well conditioned and held to 1e-7.
    check_run_vs_cpu(dev, hydro_check_run, cpu["5"],
                     ("ps", "t", "qv", "u", "v"), "hydrostatic")

    stamp('6. MOLOCH path')
    # -- 6. MOLOCH path: the flagship 3 km domain, f32, 24 steps
    mcfg = RegCMConfig()
    mcfg.core.idynamic = 3
    mcfg.dim.iy = mcfg.dim.jx = 192
    mcfg.dim.kz = 41
    mcfg.geo.ds = 3.0
    mcfg.time.dt = 30.0
    mgrid = build_grid(mcfg)
    print(f"MOLOCH model: {mgrid.jx}x{mgrid.iy}x{mgrid.kz}, dt "
          f"{mcfg.dtsec} s, ds {mcfg.geo.ds} km")
    t0 = time.time()
    ms0 = MolochCore(mgrid, mcfg, device=dev, dtype=torch.float32
                     ).initial_state(perturb=0.3, seed=1)
    model = Model(mcfg, grid=mgrid, device=dev, dtype=torch.float32,
                  initial_state=ms0)
    torch.cuda.synchronize()
    print(f"MOLOCH set-up {time.time() - t0:.1f} s")
    del ms0
    reset(mods)
    _, wall0 = model.run(DECOMP_STEPS)
    single12 = model.decoupled()        # phase 10 compares with it
    _, wall = model.run(STEPS - DECOMP_STEPS)
    moloch_launches = read(mods)
    print(f"MOLOCH one card ms/step (f32, 192x192x41, steps "
          f"{DECOMP_STEPS}..{STEPS - 1}: cumulus and surface at 20, no "
          f"radiation; synchronised): "
          f"{1000.0 * wall / (STEPS - DECOMP_STEPS):.3f} on {smi}")
    print(f"MOLOCH path: {STEPS} steps in {wall0 + wall:.3f} s; launches "
          f"{moloch_launches}")
    if not model.check_finite():
        raise AssertionError("non-finite MOLOCH state after the f32 run")
    if min(moloch_launches.values()) <= 0:
        raise AssertionError(f"MOLOCH path bypassed a kernel: "
                             f"{moloch_launches}")
    d = model.decoupled()
    wmax = float(np.abs(d["w"]).max())
    print(f"MOLOCH ps {d['ps'].min():.3f}..{d['ps'].max():.3f} hPa, "
          f"wmax {wmax:.4f} m/s, T {d['t'].min():.3f}..{d['t'].max():.3f} K")
    # the band of the JAX package at step 24 on a 48x48 cut of this
    # domain (979.3-1055.2 hPa, wmax 3.14 m/s; REFERENCE below), widened
    # for the larger domain's extremes
    if not (960.0 < d["ps"].min() and d["ps"].max() < 1075.0
            and wmax < 6.0):
        raise AssertionError("MOLOCH f32 run left the reference's band")
    _, wall = model.run(STEPS)
    print(f"MOLOCH ms/step (f32, 192x192x41, steps {STEPS}..{2 * STEPS - 1}:"
          f" cumulus at 30 and 40, surface at 40, no radiation; "
          f"synchronised): {1000.0 * wall / STEPS:.3f} on {smi}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB")
    if not model.check_finite():
        raise AssertionError("non-finite MOLOCH state after 48 steps")
    profile_steps(model, 4)
    # the radiation step: dtrad 30 min = 60 steps. A whole 60-step cycle
    # is not timed: from this state the reference itself goes non-finite
    # before step 120 (tests/test_torch_moloch_3km_long.py)
    model.run(RAD_STEP - model.nstep)
    if not model._flags().do_rad:
        raise AssertionError(f"no radiation alarm at step {RAD_STEP}")
    _, wall = model.run(1)
    print(f"MOLOCH radiation step (step {RAD_STEP}: radiation, surface, "
          f"cumulus; synchronised): {1000.0 * wall:.3f} ms on {smi}")
    if not model.check_finite():
        raise AssertionError(f"non-finite MOLOCH state after "
                             f"{model.nstep} steps")
    d = model.decoupled()
    print(f"MOLOCH step {model.nstep}: ps {d['ps'].min():.3f}.."
          f"{d['ps'].max():.3f} hPa, wmax {np.abs(d['w']).max():.4f} m/s, "
          f"T {d['t'].min():.3f}..{d['t'].max():.3f} K")
    del model, d
    torch.cuda.empty_cache()

    stamp('6b. the same settings')
    # -- 6b. the same settings on a 48x48 cut, held to the JAX package's
    # numbers in this regime (tests/test_torch_moloch_3km.py)
    rcfg = RegCMConfig()
    rcfg.core.idynamic = 3
    rcfg.dim.iy = rcfg.dim.jx = 48
    rcfg.dim.kz = 41
    rcfg.geo.ds = 3.0
    rcfg.time.dt = 30.0
    rgrid = build_grid(rcfg)
    model = Model(rcfg, grid=rgrid, device=dev, dtype=torch.float32,
                  initial_state=MolochCore(rgrid, rcfg, device=dev,
                                           dtype=torch.float32
                                           ).initial_state(perturb=0.3,
                                                           seed=1))
    for n in range(1, max(REFERENCE) + 1):
        model.run(1)
        if n in REFERENCE:
            d = model.decoupled()
            got = (float(d["ps"].min()), float(d["ps"].max()),
                   float(np.abs(d["w"]).max()))
            lo, hi, w = REFERENCE[n]
            print(f"MOLOCH 48x48x41 f32 step {n}: ps {got[0]:.4f}.."
                  f"{got[1]:.4f} hPa, wmax {got[2]:.5f} m/s; JAX package "
                  f"{lo:.4f}..{hi:.4f} hPa, {w:.5f} m/s")
            if not (abs(got[0] - lo) < 0.1 and abs(got[1] - hi) < 0.1
                    and abs(got[2] - w) < 0.01 * w):
                raise AssertionError(f"MOLOCH step {n} on the card leaves "
                                     f"the reference: {got}")
    del model

    stamp('7. MOLOCH card against CPU')
    # -- 7. MOLOCH card against CPU, f64, 16x20x14 over an ~800 m hill,
    # 10 steps, held as the hydrostatic path is
    check_run_vs_cpu(dev, moloch_check_run, cpu["7"],
                     ("ps", "t", "qv", "u", "v", "w"), "MOLOCH")

    stamp('9. the decomposed kernels')
    # -- 9. the decomposed kernels on 2x2 blocks, one process
    k5_stats = compare_decomposed(dev, mods)
    stats.update(k5_stats)
    compare_uneven(dev, k4)

    stamp('13. the ICBC-driven runs')
    # -- 13. the ICBC-driven runs on one card (phase 12 is held to 13a);
    # phase 18's SAV files and output streams (~2.5 GB) go to the
    # git-ignored _phase18 beside this script and are deleted at the end
    tmp = tempfile.mkdtemp(prefix="chip_smoke_icbc_")
    p18 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_phase18")
    os.makedirs(p18, exist_ok=True)
    try:
        t0 = time.time()
        paths = write_icbc_files(tmp)
        paths["phase18"] = p18
        print(f"ICBC files (port's terrain and icbc, one day) written in "
              f"{time.time() - t0:.1f} s")
        chains = {name: Chain(name, p18) for name in CHAIN_STEPS}
        icbc13 = run_icbc_single(dev, smi, paths, mods, chains)

        stamp('14a, 14b, 14d')
        # -- 14a, 14b, 14d. the NH core on one card
        nh14 = run_nh_single(dev, smi, mods, chains["NH"])
        stamp("14b, 14d")
        nh_card_vs_cpu(dev, cpu["14b"])
        options_card_vs_cpu(dev, cpu["14d"])

        stamp('15a-d')
        # -- 15a-d. the second physics set on one card
        a15 = run_schemes_a(dev, smi, paths, mods)
        stamp("15b")
        b15 = run_schemes_b(dev, smi, mods)
        stamp("15c")
        schemes_card_vs_cpu(dev, cpu["15c"])
        stamp("15d")
        nf10 = compare_nf10(dev, k4)

        stamp('16a-c')
        # -- 16a-c. the remaining cumulus schemes on one card
        t16 = time.time()
        c16 = run_config_c(dev, smi, write_eur44_files(tmp), mods)
        stamp("16b")
        cu16 = run_cumulus_schemes(dev, smi, paths, mods)
        stamp("16c")
        cumulus_card_vs_cpu(dev, cpu["16c"])
        print(f"phase 16a-c took {time.time() - t16:.1f} s")

        stamp('17a, 17c, 17d')
        # -- 17a, 17c, 17d. configuration D and the other new settings
        t17 = time.time()
        paths.update(write_band_files(tmp))
        d17 = run_band(dev, smi, paths, mods)
        stamp("17c")
        run_new_settings(dev, smi, paths, mods)
        stamp("17d")
        new_card_vs_cpu(dev, cpu["17d"])
        print(f"phase 17a, 17c, 17d took {time.time() - t17:.1f} s")

        stamp('18a, 18c')
        # -- 18a, 18c. restart chains and output streams on one card
        t18 = time.time()
        run_restart_chains(dev, smi, paths, chains)
        run_output(dev, smi, paths, chains["MOLOCH"].path, p18)
        print(f"phase 18a, 18c took {time.time() - t18:.1f} s")

        stamp('19a-d, 19f')
        # -- 19a-d, 19f. the aerosol chemistry on one card, and 19e's
        # single-card reference
        t19 = time.time()
        e19a = run_chem_e(dev, smi, paths, mods)
        stamp("19b, 19f")
        run_chem_b_f(dev, smi, paths, p18)
        stamp("19c")
        c19 = run_chem_moloch(dev, smi, paths, mods)
        stamp("19d")
        chem_card_vs_cpu(dev, cpu["19d"])
        e19 = chem_single(dev, paths)
        print(f"phase 19a-d, 19f took {time.time() - t19:.1f} s")

        stamp('20a-c')
        # -- 20a-c. the gas-phase chemistry on one card, and 20d's
        # single-card reference
        f20, g20 = run_gas_phase(dev, smi, paths, mods, tmp, cpu["20c"])
        # every CPU run has been read: the pool's processes end here,
        # before the decomposed group's ranks start
        pools[0].shutdown()
        print(f"CPU pool: {len(CPU_DONE)} runs on {CPU_WORKERS} "
              f"processes, the last done at {max(CPU_DONE):.1f} s")

        stamp('10, 11, 12, 14c, 15e, 16d, 17b, 18b, 18d, 19e, 20d')
        # -- 10, 11, 12, 14c, 15e, 16d, 17b, 18b, 18d, 19e, 20d. the
        # decomposed runs
        decomp = run_decomposed(dev, smi, single12, paths, icbc13,
                                nh14["single12"], a15["rec"],
                                cu16["c_single12"], d17["rec"], e19, g20)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(p18, ignore_errors=True)

    if "jax" in sys.modules or any(
            m == "regcm_tpu" or m.startswith("regcm_tpu.")
            for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")

    # -- results: timings at the MOLOCH shape (K5: one 96x96 block), ms
    # through the wrapper and device_ms the launched kernels alone;
    # launches from each kernel's path: K1-K4 from phase 6's run, K5
    # from rank 0 of phase 10's gloo run (every rank's in launches_ranks);
    # K5c and K2 also per step on each rank of phase 12's test_001 run;
    # no single PyTorch call computes any of these functions, so
    # library_ms is null
    kernels = []
    ranks = decomp["gloo"]
    for k in NAMES:
        st = stats[k]["moloch"]
        row = dict(
            name=NAMES[k], route="cuda",
            source=f"regcm_tpu_torch/csrc/{SOURCE[k]}.cu",
            replaces=REPLACES[k],
            launches=(ranks[0]["launches"][k] if k in BASE
                      else moloch_launches[k]),
            max_abs_err=st["max_abs_err"], ms=st["ms"],
            device_ms=st["device_ms"], plain_ms=st["plain_ms"],
            bound_ms=st["bound_ms"],
            bound_by=st["bound_by"], library_ms=None, shape=st["shape"])
        if k in REDESIGNED:
            row["redesigned"] = REDESIGNED[k]
        if k in ("K2", "K5c"):
            row["launches_per_step_hydrostatic_2x2"] = {
                b: [r["hydro"]["launches"][k] / HYDRO_CHECK[1]
                    for r in res] for b, res in decomp.items()}
            row["launches_per_step_nh_2x2"] = {
                b: [r["nh"]["launches"][k] / DECOMP_STEPS for r in res]
                for b, res in decomp.items()}
        if k in ("K1", "K2"):
            row["launches_per_step_nh"] = nh14["per_step"][k]
        # phase 15: launches a step of configurations A (one card, 150
        # steps) and B (one card, 24 steps); K4 and K5a at nf = 10
        if k in BASE:           # A on 2x2 ranks (15e, rank 0)
            row["launches_per_step_A_2x2"] = ranks[0]["schemes"][
                "launches"].get(k, 0) / HYDRO_CHECK[0]
        else:
            row["launches_per_step_A"] = a15["per_step"][k]
            row["launches_per_step_B"] = b15["per_step"][k]
        if k in ("K4", "K5a"):
            row["nf10"] = nf10[k]
        # phase 16: launches a step of configuration C (one card at the
        # EUR-44 extent, 150 steps; K5c on 2x2 ranks, 16d, rank 0)
        if k in ("K1", "K2"):
            row["launches_per_step_C"] = c16["per_step"][k]
        if k == "K5c":
            row["launches_per_step_C_2x2"] = ranks[0]["cumulus"][
                "launches"]["K5c"] / HYDRO_CHECK[0]
        # phase 17: configuration D (one card at full width, 24 steps;
        # K5c on 2x2 ranks, 17b, rank 0)
        if k in ("K1", "K2"):
            row["launches_per_step_D"] = d17["per_step"][k]
            row["D_operands"] = d17["operands"][k]
        if k == "K5c":
            row["launches_per_step_D_2x2"] = ranks[0]["band"][
                "launches"]["K5c"] / D_CHECK
        # phase 19: configuration E (K1 twice a step, its tracer call on
        # E's operands; K5c on 2x2 ranks, 19e, rank 0), K1 on the MOLOCH
        # flagship with DUST (19c)
        if k == "K1":
            row.update(launches_per_step_F=f20["per_step"]["K1"],
                       F_tracer_operands=f20["operands"]["K1"])
            row.update(launches_per_step_E=e19a["per_step"]["K1"],
                       E_tracer_operands=e19a["operands"]["K1"][
                           "E's operands"],
                       launches_per_step_moloch_dust=c19["per_step_k1"])
        if k == "K4":
            row["nf_moloch_dust"] = c19["nf"]
        if k == "K5c":
            row["launches_per_step_E_2x2"] = ranks[0]["chem"][
                "launches"]["K5c"] / E_CHECK
        if k in BASE:
            row["launches_ranks"] = {b: [r["launches"][k] for r in res]
                                     for b, res in decomp.items()}
        else:
            row.update(launches_hydrostatic=hydro_launches[k],
                       small_shape=stats[k]["small"])
        kernels.append(row)
    # K2's tracer form: launches from 20a's main path (configuration F,
    # ntr = 50), its error, times and bound on F's operands (f32); E's
    # (phase 19a, ntr = 12) beside
    st = f20["operands"]["K2"]
    kernels.append(dict(
        name="emanuel_mixing_tracers", route="cuda",
        source=f"regcm_tpu_torch/csrc/{SOURCE['K2']}.cu",
        replaces=REPLACES["K2"],
        contraction_of="regcm_tpu/physics/cumulus/emanuel.py:352",
        launches=f20["launches"]["K2_tracers"], max_abs_err=st["max_abs_err"],
        ms=st["ms"], device_ms=st["device_ms"], plain_ms=st["plain_ms"],
        bound_ms=st["bound_ms"], bound_by=st["bound_by"], library_ms=None,
        shape=st["shape"], launches_per_cumulus_step_F=f20["per_step"]["K2"],
        launches_per_cumulus_step_E=e19a["per_step"]["K2"],
        E_operands=e19a["operands"]["K2"]["E's operands"],
        E_synthetic_clouds=e19a["operands"]["K2"]["clouds at E's shape"]))
    # K6: the gas-phase Ros2's batched LU (no TPU kernel: the JAX package
    # computes jax.scipy.linalg.lu_factor/lu_solve in XLA), launches from
    # 20a's main path, on F's stage matrices; library_ms is the plain
    # version, torch.linalg.lu_factor/lu_solve
    for k, name, line in (("K6a", "gas_lu_factor_solve", 122),
                          ("K6b", "gas_lu_solve", 127)):
        st = f20["operands"][k]
        kernels.append(dict(
            name=name, route="cuda", source="regcm_tpu_torch/csrc/gas_lu.cu",
            replaces=f"regcm_tpu/chem/kinetics.py:{line}",
            launches=f20["launches"][k], max_abs_err=st["max_abs_err"],
            ms=st["ms"], device_ms=st["device_ms"], plain_ms=st["plain_ms"],
            bound_ms=st["bound_ms"], bound_by=st["bound_by"],
            library_ms=st["library_ms"], shape=st["shape"],
            gas_solver_F=f20["gas"]))
    for ev in EVENT_TIMED:
        print(f"device_ms of {ev['kernels']} is CUDA-event time "
              f"({ev['ms']:.4f} ms): no profiler trace showed the kernel")
    print(f"chip_smoke ran in {time.time() - t_all:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def main():
    pools = []
    try:
        run(pools)
    finally:
        for pool in pools:
            pool.shutdown(wait=False, cancel_futures=True)


if __name__ == "__main__":
    main()
