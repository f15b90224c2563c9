"""The DOMAIN and ICBC files of the ICBC settings of
``tests/_torch_parallel_ranks.py`` (``ICBC``), written by the JAX
package's preprocessors; both packages' readers then read the same
files."""
import os

from . import _torch_parallel_ranks as R


def write_files(kind, directory):
    """Write the setting's files into ``directory``: the records of
    ``generate_synthetic_icbc``'s window and cadence, each record's jet
    ``djet`` m/s stronger than the one before. Returns the paths
    (``icbc``, and ``domain`` for the hydrostatic setting)."""
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.preproc.icbc import ICBCWriter, synthetic_fields
    from regcm_tpu.preproc.terrain import synthetic_topo, write_domain
    from regcm_tpu.utils.calendar import Date
    st = R.ICBC[kind]
    cfg = R.icbc_setup(RegCMConfig(), kind)
    topo, lnd, mask = synthetic_topo(cfg, kind=st["kind"],
                                     height=st["height"])
    paths = dict(icbc=os.path.join(directory, f"{kind}_ICBC.nc"))
    if cfg.core.idynamic == 1:
        paths["domain"] = os.path.join(directory, f"{kind}_DOMAIN000.nc")
        write_domain(cfg, paths["domain"], topo, lnd, mask)
    cal = cfg.globdat.calendar
    d = Date.from_int(cfg.globdat.gdate1, cal)
    end = Date.from_int(cfg.globdat.gdate2, cal)
    w = ICBCWriter(paths["icbc"], cfg)
    n = 0
    while d <= end:
        w.append(d, synthetic_fields(cfg, topo, d,
                                     jet=st["jet"] + n * st["djet"]))
        d = d.add_hours(cfg.globdat.ibdyfrq)
        n += 1
    w.close()
    return paths
