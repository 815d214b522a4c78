"""The port's eval and training CLI on the model variants, on the CPU: one
eval chunk of TensorCP and of the stacked TensorVM against the JAX
package's, and the CLI with ``--model_name TensorCP`` and ``TensorVM``
through a mask, shrink, upsample, relight steps, an eval, ckpt_final of
the decomposition and a render-only run from it.

Tolerance: eval maps 1e-4 absolute (test_torch_eval.py's), against JAX's
chunk run eagerly (the test says why).
"""
import math

import jax
import numpy as np
import pytest

from tensoir_tpu.render import eval as JE

from tensoir_tpu_torch import train_tensoir as TCLI
from tensoir_tpu_torch.data.synthetic import write_shadow_scene
from tensoir_tpu_torch.render import eval as TE
from tensoir_tpu_torch.utils import ckpt as TCK

from torch_parity import (masked_jax_field, one_torch_thread,  # noqa: F401
                          port_cfg, port_field, rays)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

S = 48


@pytest.mark.parametrize("decomp", ["cp", "vm_stacked"])
def test_eval_chunk_of_each_decomposition_matches_jax(decomp):
    """One eval chunk of 24 rays, every ray relit under the fixed
    directions, on the exact march (CP keeps its exact appearance path).
    Held against JAX's chunk run eagerly: JAX's jitted bake folds the alpha
    mask into a few more grid nodes on the mask's edge (XLA fuses the
    mask's resampling; test_torch_secondary.py), and on the CP field those
    nodes carry features near 1 that fill the secondary march's cap of
    occupied samples in the port and in JAX's eager bake alike."""
    jcfg, jp, js = masked_jax_field(decomp=decomp)
    tp, ts = port_field(jp, js)
    r = rays(24, seed=12, spread=0.15)
    lidx = np.zeros((24, 1), np.int32)
    knobs = dict(second_n_sample=16, secondary_tile=384)
    j_fn, c = JE.make_eval_chunk_fn(jcfg, n_samples=S, chunk=24, **knobs)
    t_fn, _ = TE.make_eval_chunk_fn(port_cfg(jcfg), n_samples=S, chunk=24,
                                    **knobs)
    with jax.disable_jit():
        j_out = JE.render_image(j_fn, c, jp, js, r, lidx)
    t_out = TE.render_image(t_fn, c, tp, ts, r, lidx)
    assert set(t_out) == set(j_out)
    assert 3 < (j_out["acc_map"] > 0.5).sum() < 24
    for k, jv in j_out.items():
        d = np.abs(t_out[k].astype(np.float64) - jv.astype(np.float64)).max()
        assert d <= 1e-4, (k, d)


TINY = """
dataset_name = tensoIR_unknown_rotated_lights
expname = tiny
n_iters = 6
batch_size = 128
N_voxel_init = 4096
N_voxel_final = 8000
upsamp_list = [4]
update_AlphaMask_list = [2]
N_vis = 1
vis_every = 3
render_test = 1
test_number = 1
n_lamb_sigma = [4,4,4]
n_lamb_sh = [6,6,6]
data_dim_color = 8
featureC = 16
nSamples = 48
numLgtSGs = 8
envmap_h = 4
envmap_w = 8
second_nSample = 16
relight_ray_cap = 16
secondary_tile = 256
batch_size_test = 64
save_iters = 0
light_rotation = [000]
light_name = sunset
"""


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants_cli")
    write_shadow_scene(str(root / "scene"), str(root / "hdr"),
                       views=(("train", 2, 16), ("test", 1, 12)),
                       env_hw=(16, 32))
    (root / "tiny.txt").write_text(TINY)
    return root


@pytest.mark.parametrize("model,prefix", [("TensorCP", "density_line"),
                                          ("TensorVM", "stack_plane")])
def test_cli_trains_each_decomposition(scene, model, prefix):
    """The CLI with --model_name: mask, shrink, upsample, relight steps, an
    eval, ckpt_final of the decomposition; render-only from it reproduces
    the final test metrics."""
    argv = ["--config", str(scene / "tiny.txt"), "--datadir",
            str(scene / "scene"), "--hdrdir", str(scene / "hdr"),
            "--basedir", str(scene / f"log_{model}"), "--model_name", model]
    res = TCLI.main(argv, device="cpu")["imgs_test_all"]
    assert all(math.isfinite(res[k]) for k in ("psnr_nvs", "psnr_nvs_brdf"))
    ckpt = scene / f"log_{model}" / "tiny" / "ckpt_final.npz"
    fcfg, params, _, _ = TCK.load_checkpoint(str(ckpt), device="cpu")
    assert fcfg.decomp == {"TensorCP": "cp", "TensorVM": "vm_stacked"}[model]
    assert f"{prefix}_0" in params
    assert ("density_plane_0" in params) is False
    # upsampled to 20^3 voxels from 16^3
    assert params[f"{prefix}_0"].shape[0] == 20
    again = TCLI.main(argv + ["--render_only", "1", "--ckpt", str(ckpt)],
                      device="cpu")
    assert again["imgs_test_all"] == res
