"""Terrain preprocessor (the ``terrain`` executable equivalent).

Mirrors ``PreProc/Terrain/terrain.F90:36-146``: builds the model grid
from the namelist, interpolates source topography/landuse onto it,
applies smoothing, and writes a ``<domname>_DOMAIN000.nc`` with the
reference schema (``PreProc/Terrain/mod_write.F90`` variable names:
topo/landuse/xlat/xlon/dlat/dlon/xmap/dmap/coriol/mask/ps0/ts0...).

Data sources:
- real GMTED/GLCC tile archives when present (read via io.ncio;
  the windowed tile reader of Share/mod_rdldtr.F90 is a later round), or
- analytic/synthetic terrain (``synthetic_topo``) so the full model
  chain runs without external datasets.

A copy of ``regcm_tpu/preproc/terrain.py`` (JAX-free) on the port's own
``core.grid`` and ``io.ncio``, held equal to it by
``tests/test_torch_shared.py``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config.params import RegCMConfig
from ..core.grid import build_grid
from ..utils import constants as c
from ..utils.projections import grid_geometry
from ..utils.vertical import sigma_levels
from ..io.ncio import NCWriter


def synthetic_topo(cfg: RegCMConfig, kind: str = "gauss",
                   height: float = 1500.0, land_frac: float = 0.6,
                   seed: int = 0):
    """Analytic topography + landuse for dataset-free runs.

    kind: 'flat', 'gauss' (single mountain), 'ridge', 'random'.
    Returns (topo_m, landuse, mask) on the cross grid (iy-1, jx-1)."""
    iy, jx = cfg.dim.iy - 1, cfg.dim.jx - 1
    yy, xx = np.meshgrid(np.arange(iy), np.arange(jx), indexing="ij")
    yc, xc = (iy - 1) / 2.0, (jx - 1) / 2.0
    if kind == "flat":
        topo = np.zeros((iy, jx))
    elif kind == "gauss":
        r2 = ((yy - yc) / (iy / 6.0)) ** 2 + ((xx - xc) / (jx / 6.0)) ** 2
        topo = height * np.exp(-r2)
    elif kind == "ridge":
        topo = height * np.exp(-((xx - xc) / (jx / 8.0)) ** 2)
    else:
        rng = np.random.default_rng(seed)
        base = rng.standard_normal((iy // 4 + 2, jx // 4 + 2))
        from numpy import kron
        topo = np.maximum(kron(base, np.ones((4, 4)))[:iy, :jx], 0.0) \
            * height
    # landuse: ocean (15 in BATS legend = inland water; 14/15 water) in
    # the lowest areas, crop/forest elsewhere
    thresh = np.quantile(topo, 1.0 - land_frac) if topo.max() > 0 else 0.5
    lnd = np.where(topo > thresh, 2.0, 15.0)     # 2=crop, 15=water
    if topo.max() <= 0.0:
        lnd = np.where(((yy + xx) % 2) < 2.0 * land_frac, 2.0, 15.0)
    mask = np.where(lnd < 14.5, 1.0, 0.0)
    return topo, lnd, mask


def smoothing(topo: np.ndarray, npass: int = 2) -> np.ndarray:
    """1-2-1 smoother (PreProc/Terrain/mod_smooth.F90 smth121)."""
    t = topo.copy()
    for _ in range(npass):
        t[1:-1, :] = 0.25 * (t[:-2, :] + 2.0 * t[1:-1, :] + t[2:, :])
        t[:, 1:-1] = 0.25 * (t[:, :-2] + 2.0 * t[:, 1:-1] + t[:, 2:])
    return t


def write_domain(cfg: RegCMConfig, path: str, topo=None, landuse=None,
                 mask=None, smooth_passes: int = 2) -> str:
    """Create the DOMAIN file (terrain main program equivalent)."""
    if topo is None:
        topo, landuse, mask = synthetic_topo(cfg)
    topo = smoothing(np.asarray(topo, np.float64), smooth_passes)
    iy, jx = cfg.dim.iy, cfg.dim.jx
    g = grid_geometry(cfg.geo.iproj, cfg.ds_m, cfg.geo.clat, cfg.geo.clon,
                      jx, iy, truelat1=cfg.geo.truelatl,
                      truelat2=cfg.geo.truelath, plat=cfg.geo.plat,
                      plon=cfg.geo.plon)
    sf, sh, dsg = sigma_levels(cfg.dim.kz, cfg.dim.dsmax, cfg.dim.dsmin)
    cut = lambda a: np.asarray(a)[: iy - 1, : jx - 1]
    w = NCWriter(path, dims={"iy": iy - 1, "jx": jx - 1,
                             "kz": cfg.dim.kz, "kzp1": cfg.dim.kz + 1},
                 attrs={"title": "regcm_tpu DOMAIN file",
                        "projection": cfg.geo.iproj,
                        "grid_size_in_meters": cfg.ds_m,
                        "latitude_of_projection_origin": cfg.geo.clat,
                        "longitude_of_projection_origin": cfg.geo.clon,
                        "experiment": cfg.terrain.domname})
    w.def_static("sigma", ("kzp1",), sf, "1", "Sigma at full levels")
    w.def_static("topo", ("iy", "jx"), topo, "m", "Surface elevation",
                 "surface_altitude")
    w.def_static("landuse", ("iy", "jx"), landuse, "1",
                 "Landuse category (BATS legend)", "land_type")
    w.def_static("mask", ("iy", "jx"), mask, "1", "Land mask",
                 "land_binary_mask")
    w.def_static("xlat", ("iy", "jx"), cut(g["xlat"]), "degrees_north",
                 "Latitude on cross points", "latitude")
    w.def_static("xlon", ("iy", "jx"), cut(g["xlon"]), "degrees_east",
                 "Longitude on cross points", "longitude")
    w.def_static("dlat", ("iy", "jx"), cut(g["dlat"]), "degrees_north",
                 "Latitude on dot points")
    w.def_static("dlon", ("iy", "jx"), cut(g["dlon"]), "degrees_east",
                 "Longitude on dot points")
    w.def_static("xmap", ("iy", "jx"), cut(g["msfx"]), "1",
                 "Map factor cross points", "map_factor")
    w.def_static("dmap", ("iy", "jx"), cut(g["msfd"]), "1",
                 "Map factor dot points", "map_factor")
    w.def_static("coriol", ("iy", "jx"), cut(g["coriol"]), "s-1",
                 "Coriolis parameter", "coriolis_parameter")
    # NH reference surface pressure/temperature (ps0/ts0)
    z = topo
    p0 = 101325.0 * np.exp(-c.egrav * z / (c.rgas * 0.5
                                           * (c.stdt + np.maximum(
                                               c.stdt - c.lrate * z,
                                               c.tiso))))
    t0 = np.maximum(c.stdt - c.lrate * z, c.tiso)
    w.def_static("ps0", ("iy", "jx"), p0, "Pa",
                 "Base state surface pressure")
    w.def_static("ts0", ("iy", "jx"), t0, "K",
                 "Base state surface temperature",
                 "base_state_surface_temperature")
    w.close()
    return path


def read_domain(path: str):
    """Read a DOMAIN file (ours or reference-generated)."""
    from ..io.ncio import read_nc
    return read_nc(path)


def build_grid_from_domain(cfg: RegCMConfig, path: str):
    """ModelGrid from a DOMAIN file (mod_domain read path)."""
    d = read_domain(path)
    return build_grid(cfg, ht=d["topo"], landmask=d["mask"])


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="terrain preprocessor")
    ap.add_argument("namelist")
    ap.add_argument("--kind", default="gauss",
                    choices=["flat", "gauss", "ridge", "random"])
    ap.add_argument("--height", type=float, default=1500.0)
    args = ap.parse_args(argv)
    cfg = RegCMConfig.from_file(args.namelist)
    out = os.path.join(cfg.terrain.dirter
                       if os.path.isdir(cfg.terrain.dirter) else ".",
                       f"{cfg.terrain.domname}_DOMAIN000.nc")
    topo, lnd, mask = synthetic_topo(cfg, kind=args.kind,
                                     height=args.height)
    write_domain(cfg, out, topo, lnd, mask)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
