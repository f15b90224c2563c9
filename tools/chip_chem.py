#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (the aerosol chemistry) alone, with
only what it needs: the four CUDA kernels built, K2's tracer form held
to its plain version on synthetic operands at configuration E's shape
(f32 and f64), then phases 19a-d and 19f on one card and 19e's 2x2
group (gloo) against one card. Run from the repository root:

    python3 tools/chip_chem.py            # every part of phase 19
    python3 tools/chip_chem.py --kernels  # the build and the K2 check

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


def tracer_form_check(dev):
    """K2's tracer form on phase 3's synthetic clouds at E's shape
    (112,280 columns of 18 levels, 12 tracers) and at L = 41 with 32
    tracers, against its plain version in f32 (1e-5) and f64 (1e-12)."""
    import torch
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    rng = np.random.default_rng(3)
    for (ncol, L), ntr in (((cs.BAND[0] * cs.BAND[1], cs.BAND[2]), 12),
                           ((4096, 41), 32)):
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
    with ThreadPoolExecutor(len(mods)) as ex:
        for fut in [ex.submit(m.build) for m in mods.values()]:
            fut.result()
    print(f"kernels built in {time.time() - t0:.1f} s")
    tracer_form_check(dev)
    if "--kernels" in sys.argv[1:]:
        return
    tmp = tempfile.mkdtemp(prefix="chip_chem_")
    try:
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
