"""Tiny sizes of the benchmark's cells, for the CPU tests: the same keys
and paths, widths and counts cut so that a run takes seconds."""
from __future__ import annotations

import copy
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent

CONFIG = dict(
    batch_size=64, batch_size_test=64, n_lamb_sigma=[4, 4, 4],
    n_lamb_sh=[6, 6, 6], data_dim_color=8, featureC=16, numLgtSGs=8,
    envmap_h=4, envmap_w=8, second_nSample=8, relight_ray_cap=16,
    secondary_tile=128, march_cap_primary=16, app_cap_per_ray=8)
SCENE = {"armadillo": dict(init_voxels=16 ** 3, final_voxels=24 ** 3)}
TRAFFIC = dict(views=2, image=16, checked_chunks=2, warm_chunks=[0],
               env_hw=[8, 16], light_samples=8, lights=2, chunk=16,
               march_cap=16, app_cap=8, vis_march_cap=4)


def cell(name: str) -> tuple:
    """(cell entry, configuration file, traffic file) of a BENCHMARK.json
    cell at the tiny sizes."""
    m = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in m["workloads"]}[name]
    conf = json.loads((PKG / "configs" / f"{entry['config']}.json")
                      .read_text())
    conf = copy.deepcopy(conf)
    conf["config"].update(CONFIG)
    conf["scene"].update(SCENE[entry["config"]])
    traffic = json.loads((PKG / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    traffic.update({k: v for k, v in TRAFFIC.items() if k in traffic})
    return entry, conf, traffic
