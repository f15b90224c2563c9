#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (the aerosol chemistry) or phase 20
(the gas-phase chemistry) alone, with only what it needs: the five CUDA
kernels built, K2's tracer form held to its plain version on synthetic
operands at configuration E's shape and past 32 tracers (f32 and f64),
then phases 19a-d and 19f on one card and 19e's 2x2 group (gloo) against
one card; with ``--gas``, K6 (the gas solver's batched LU) on synthetic
stage matrices and K2's tracer form at 32 tracers and fewer against the
previous source (the one before it took more than 32, bit for bit), then
phases 20a-c on one card and 20d's 2x2 group against one card. Run from
the repository root:

    python3 tools/chip_chem.py            # every part of phase 19
    python3 tools/chip_chem.py --gas      # every part of phase 20
    python3 tools/chip_chem.py --kernels  # the build and the kernel checks

It exits nonzero if a part fails, as ``chip_smoke.py`` does.
"""
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def chem_group(rank, paths):
    """One rank of 19e's group (``chip_smoke.chem_rank``)."""
    return dict(chem=cs.chem_rank(rank, paths))


def gas_group(rank, paths):
    """One rank of 20d's group (``chip_smoke.gas_rank``)."""
    return dict(gas=cs.gas_rank(rank, paths))


# the tracer form's source before it took more than 32 tracers: the
# current source with its limit and shared-memory opt-in taken back
PREVIOUS_K2 = (
    ("""// the tracer form's limit: its sums take WPB * ntr * 32 NS values of
// dynamic shared memory (up to 64 KB in f64 at 64 levels), beside the
// 14 KB of static; past the default 48 KB the launch opts in to more
// (cudaFuncAttributeMaxDynamicSharedMemorySize; 227 KB a block on sm_90).
// Each tracer's sums are its own, so the limit changes no number.
constexpr int MAX_TRA = 64;
constexpr size_t DEFAULT_SMEM = 48 * 1024;""",
     """// the tracer form's limit: its sums take WPB * MAX_TRA * 64 values of
// dynamic shared memory (32 KB in f64), beside the 14 KB of static
constexpr int MAX_TRA = 32;"""),
    ("""    // the opt-in past 48 KB, once per instantiation and largest size
    static size_t opted = DEFAULT_SMEM;
    if (smem > opted) {
        const cudaError_t e = cudaFuncSetAttribute(
            emanuel_mixing_kernel<T, NS, TRA>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        opted = smem;
    }
""", ""))


def previous_k2(directory):
    """The previous K2 source built into ``directory``, loaded with the
    wrapper's signatures."""
    import ctypes
    import subprocess
    from pathlib import Path
    from regcm_tpu_torch.kernels import _build
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    src = (_build.CSRC / "emanuel_mixing.cu").read_text()
    for new, old in PREVIOUS_K2:
        if new not in src:
            raise AssertionError("the K2 source no longer holds the change "
                                 "this check takes back")
        src = src.replace(new, old)
    cu = Path(directory) / "emanuel_mixing_previous.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-fmad=false", "-o",
                    str(so), str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("emanuel_mixing_tra_f32", "emanuel_mixing_tra_f64"):
        getattr(lib, fn).argtypes = k2._SIG_TRA
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def previous_k2_check(dev, directory):
    """K2's tracer form at 12 and 32 tracers (L 18 and 41, f32 and f64)
    bit for bit the previous source's."""
    import torch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.utils import constants as c
    lib = previous_k2(directory)
    rng = np.random.default_rng(9)
    for (ncol, L), ntr in (((4096, 18), 12), ((4096, 41), 32),
                           ((4096, 18), 32)):
        for dtype in (torch.float32, torch.float64):
            args = cs.k2_inputs((ncol, L), dtype, dev)
            tra = torch.as_tensor(rng.uniform(0, 1e-6, (ncol, L, ntr)),
                                  dtype=dtype, device=dev)
            trank = torch.as_tensor(rng.uniform(0, 1e-6, (ncol, ntr)),
                                    dtype=dtype, device=dev)
            got = k2.emanuel_mixing(*args, tra=tra, trank=trank)
            out = torch.empty((len(k2.KEYS), ncol, L), dtype=dtype,
                              device=dev)
            sum_tra = torch.empty_like(tra)
            levels, (unk, vnk), (icb, ict), cloud = \
                args[:13], args[13:15], args[15:17], args[17]
            fn = lib.emanuel_mixing_tra_f64 if dtype == torch.float64 \
                else lib.emanuel_mixing_tra_f32
            # held until the launch is done (the caching allocator would
            # hand a freed temporary's memory to the next)
            icb32, ict32 = icb.to(torch.int32), ict.to(torch.int32)
            cld8 = cloud.to(torch.uint8)
            rc = fn(*(a.data_ptr() for a in levels), unk.data_ptr(),
                    vnk.data_ptr(), icb32.data_ptr(), ict32.data_ptr(),
                    cld8.data_ptr(), out.data_ptr(), ncol,
                    L, torch.cuda.current_stream().cuda_stream, c.rwat,
                    c.cpd, c.cpv, c.egrav, tra.data_ptr(), trank.data_ptr(),
                    sum_tra.data_ptr(), ntr)
            torch.cuda.synchronize()
            same = rc == 0 and torch.equal(got["sum_tra"], sum_tra) and all(
                torch.equal(got[k], out[n]) for n, k in enumerate(k2.KEYS))
            print(f"K2 tracer form {dtype} ({ncol}, {L}, {ntr}) against the "
                  f"previous source: "
                  f"{'bit-identical' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError("K2's tracer form differs from the "
                                     "previous source")


def gas_lu_check(dev):
    """K6 on synthetic stage matrices I/(h gamma) - J (CBMZ's 58 and CB6's 76
    species, 65,536 and 4,099 cells) against torch.linalg.lu_factor and
    lu_solve, f32 (1e-5) and f64 (1e-12)."""
    import torch
    from regcm_tpu_torch.kernels import gas_lu as k6
    rng = np.random.default_rng(6)
    for ncell, n in ((65536, 58), (4099, 76)):
        for dtype in (torch.float32, torch.float64):
            j = torch.as_tensor(rng.normal(size=(ncell, n, n)) / n ** 0.5,
                                dtype=dtype, device=dev)
            p = torch.eye(n, dtype=dtype, device=dev) * 2.0 - j
            b = torch.as_tensor(rng.normal(size=(ncell, n)), dtype=dtype,
                                device=dev)
            lu_w, piv_w, x_w = k6.lu_factor_solve_plain(p, b)
            lu, piv, x = k6.lu_factor_solve(p.clone(), b)
            y, y_w = k6.lu_solve(lu, piv, 2.0 * b), \
                k6.lu_solve_plain(lu_w, piv_w, 2.0 * b)
            torch.cuda.synchronize()
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            rel = max(cs.rel_err(x, x_w)[0], cs.rel_err(y, y_w)[0])
            kept = torch.equal(piv.long() + 1, piv_w.long())
            print(f"K6 {dtype} ({ncell}, {n}, {n}): solves max rel err "
                  f"{rel:.3e} (tol {tol:g}), pivots "
                  f"{'kept' if kept else 'NOT kept'}")
            if not rel <= tol:
                raise AssertionError("K6 disagrees with its plain version")
            del j, p, lu_w, lu
            torch.cuda.empty_cache()


def tracer_form_check(dev):
    """K2's tracer form on phase 3's synthetic clouds at E's and F's
    shapes (112,280 columns of 18 levels, 12 and 50 tracers) and at L = 41
    with 32, 51 and 64 tracers (f64 past 48 KB of shared memory), against
    its plain version in f32 (1e-5) and f64 (1e-12)."""
    import torch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    rng = np.random.default_rng(3)
    for (ncol, L), ntr in (((cs.BAND[0] * cs.BAND[1], cs.BAND[2]), 12),
                           ((cs.BAND[0] * cs.BAND[1], cs.BAND[2]), 50),
                           ((4096, 41), 32), ((4096, 41), 51),
                           ((4096, 41), 64)):
        for dtype in (torch.float32, torch.float64):
            args = cs.k2_inputs((ncol, L), dtype, dev)
            tra = torch.as_tensor(rng.uniform(0, 1e-6, (ncol, L, ntr)),
                                  dtype=dtype, device=dev)
            trank = torch.as_tensor(rng.uniform(0, 1e-6, (ncol, ntr)),
                                    dtype=dtype, device=dev)
            got = k2.emanuel_mixing(*args, tra=tra, trank=trank)
            want = k2.emanuel_mixing_plain(*args, tra=tra, trank=trank)
            torch.cuda.synchronize()
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            rel = cs.rel_err(got["sum_tra"], want["sum_tra"])[0]
            rel8 = max(cs.rel_err(got[k], want[k])[0] for k in k2.KEYS)
            print(f"K2 tracer form {dtype} ({ncol}, {L}, {ntr}): sum_tra max "
                  f"rel err {rel:.3e} (tol {tol:g}), the eight terms "
                  f"{rel8:.3e}")
            if not (rel <= tol and rel8 <= max(tol, 1e-10)):
                raise AssertionError("K2's tracer form disagrees")
            del args, tra, trank, got, want
            torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_chem: no CUDA card")
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import gas_lu as k6
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.kernels import tridiag_w as k3
    from regcm_tpu_torch.kernels import waf_advect as k4
    from regcm_tpu_torch.parallel.launch import spawn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mods = {"K1": k1, "K2": k2, "K3": k3, "K4": k4}
    smi = cs.nvidia_smi_line()
    print(smi)
    t0 = time.time()
    from concurrent.futures import ThreadPoolExecutor
    builds = [*mods.values(), k6]
    with ThreadPoolExecutor(len(builds)) as ex:
        for fut in [ex.submit(m.build) for m in builds]:
            fut.result()
    print(f"kernels built in {time.time() - t0:.1f} s")
    tracer_form_check(dev)
    gas = "--gas" in sys.argv[1:]
    tmp = tempfile.mkdtemp(prefix="chip_chem_")
    try:
        if gas or "--kernels" in sys.argv[1:]:
            gas_lu_check(dev)
            previous_k2_check(dev, tmp)
        if "--kernels" in sys.argv[1:]:
            return
        if gas:
            paths = cs.write_icbc_files(tmp)
            paths.update(cs.write_band_files(tmp))
            f20, g20 = cs.run_gas_phase(dev, smi, paths, mods, tmp)
            t0 = time.time()
            res = spawn(gas_group, *cs.GRID, "gloo", "cuda", args=(paths,),
                        timeout=600)
            cs.check_gas_decomposed(res, "gloo", g20)
            print(f"20d took {time.time() - t0:.1f} s")
            print(f"20a operands: {f20['operands']}")
            return
        paths = cs.write_icbc_files(tmp)
        paths.update(cs.write_band_files(tmp))
        t0 = time.time()
        e = cs.run_chem_e(dev, smi, paths, mods)
        print(f"19a took {time.time() - t0:.1f} s")
        t0 = time.time()
        cs.run_chem_b_f(dev, smi, paths, tmp)
        print(f"19b, 19f took {time.time() - t0:.1f} s")
        t0 = time.time()
        cs.run_chem_moloch(dev, smi, paths, mods)
        print(f"19c took {time.time() - t0:.1f} s")
        t0 = time.time()
        cs.chem_card_vs_cpu(dev)
        print(f"19d took {time.time() - t0:.1f} s")
        t0 = time.time()
        e19 = cs.chem_single(dev, paths)
        res = spawn(chem_group, *cs.GRID, "gloo", "cuda", args=(paths,),
                    timeout=600)
        cs.check_chem_decomposed(res, "gloo", e19)
        print(f"19e took {time.time() - t0:.1f} s")
        print(f"19a operands: {e['operands']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
