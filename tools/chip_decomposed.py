#!/usr/bin/env python3
"""The decomposed phases of ``chip_smoke.py`` (10-12, 14c, 15e, 16d, 17b,
18b, 18d, 19e, 20d) alone, with only what they are held to: the single card's
first 12 MOLOCH flagship steps (phase 6), the ICBC-driven runs (phase
13, with test_001's SAV after step 132 for 12b's run past the boundary
update), the NH flagship on one card (phase 14a), configurations A's,
C's and D's first 12 steps on one card (phases 15a, 16b, 17a), the
semi-Lagrangian test_001 on one card (18b, 18d), configuration E's
settings on test_001's widths on one card (19e) and CBMZ there with its
CHBC file (20d).

For a host with four or more cards, where phases 10-12 run under gloo and
under nccl (a card a rank): it spares the four-card call the phases that
need one card only. Run from the repository root:

    python3 tools/chip_decomposed.py            # every decomposed phase
    python3 tools/chip_decomposed.py --phase18  # 18b and 18d alone

It exits nonzero if a phase fails, as ``chip_smoke.py`` does.
"""
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def sl_group(rank, paths):
    """One rank of 18b and 18d's group (``chip_smoke.sl_rank``)."""
    return dict(sl=cs.sl_rank(rank, paths))


def run_sl_alone(dev, smi, paths):
    """Phases 18b and 18d alone: the one-card references, then a 2x2
    group on every backend the host allows."""
    import torch
    from regcm_tpu_torch.parallel.launch import spawn
    ref = cs.sl_single(dev, paths)
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 4
                           else [])
    for backend in backends:
        t0 = time.time()
        res = spawn(sl_group, *cs.GRID, backend, "cuda", args=(paths,),
                    timeout=900)
        print(f"18b, 18d: {backend} group ran in {time.time() - t0:.1f} s "
              f"on {smi}")
        cs.check_sl_decomposed(res, backend, ref)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_decomposed: no CUDA card")
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.kernels import emanuel_mixing as k2
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.kernels import tridiag_w as k3
    from regcm_tpu_torch.kernels import waf_advect as k4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mods = {"K1": k1, "K2": k2, "K3": k3, "K4": k4}
    smi = cs.nvidia_smi_line()
    print(f"{smi}; {torch.cuda.device_count()} card(s)")
    from regcm_tpu_torch.kernels import gas_lu as k6
    for m in [*mods.values(), k6]:
        m.build()
    if "--phase18" in sys.argv[1:]:
        tmp = tempfile.mkdtemp(prefix="chip_decomposed_")
        try:
            paths = cs.write_icbc_files(tmp)
            paths["phase18"] = tmp
            run_sl_alone(dev, smi, paths)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return
    # phase 10's reference: the flagship's first 12 steps on one card
    mcfg = cs.flagship_cfg()
    mgrid = build_grid(mcfg)
    model = Model(mcfg, grid=mgrid, device=dev, dtype=torch.float32,
                  initial_state=MolochCore(mgrid, mcfg, device=dev,
                                           dtype=torch.float32
                                           ).initial_state(perturb=0.3,
                                                           seed=1))
    t0 = time.time()
    model.run(cs.DECOMP_STEPS)
    print(f"MOLOCH one card: {cs.DECOMP_STEPS} steps (radiation at 0) in "
          f"{time.time() - t0:.1f} s")
    single12 = model.decoupled()
    del model
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_decomposed_")
    try:
        paths = cs.write_icbc_files(tmp)
        paths["phase18"] = tmp
        # phase 13, with 12b's SAV of test_001 (phase 18a's chain)
        icbc13 = cs.run_icbc_single(
            dev, smi, paths, mods,
            chains={"test_001": cs.Chain("test_001", tmp)})
        nh14 = cs.run_nh_single(dev, smi, mods)              # phase 14a
        a = cs.hydro_icbc_model(paths, dev, physics=cs.SCHEME_A)
        a.run_icbc(cs.HYDRO_CHECK[0])                        # phase 15a
        a15 = {cs.HYDRO_CHECK[0]: a.decoupled()}
        c = cs.hydro_icbc_model(paths, dev, physics=cs.SCHEME_C)
        c.run_icbc(cs.HYDRO_CHECK[0])                        # phase 16b
        c16 = c.decoupled()
        del a, c
        paths.update(cs.write_band_files(tmp))
        d = cs.band_model(paths, dev)
        d.run_icbc(cs.D_CHECK)                               # phase 17a
        d17 = d.decoupled()
        del d
        torch.cuda.empty_cache()
        e19 = cs.chem_single(dev, paths)                     # phase 19e
        paths.update(cs.write_gas_files(tmp))
        g20 = cs.gas_single(dev, paths)                      # phase 20d
        cs.run_decomposed(dev, smi, single12, paths, icbc13,
                          nh14["single12"], a15, c16, d17, e19,
                          g20)  # 10-12, 14c, 15e, 16d, 17b, 18, 19e, 20d
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
