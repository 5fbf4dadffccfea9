"""The metric networks of the port (gcd_tpu_torch/models/lpips.py,
models/inception.py, engine.validation_metrics' LPIPS) against the JAX
package's, fp32 on the CPU.

The weights are seeded random state dicts in the files' own layouts (a
torchvision VGG16 and the lpips lins; a pytorch-fid InceptionV3 with
positive running variances), read by JAX's loaders and by the port's. A
chain of 13 (VGG) or ~95 (Inception) fp32 convolutions differs between the
two sides only in the order of its sums: LPIPS within 1e-5 relative,
InceptionV3's features within 1e-4 relative L2. LatentLPIPS decodes first
(the tiny decoder's own bound, 1e-4). Every resize includes an axis that
shrinks, where jax.image.resize low-passes and torch's interpolate does
not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.io.convert import _iter_tree_paths
from gcd_tpu.models.inception import InceptionV3 as JInceptionV3
from gcd_tpu.models.inception import convert_fid_inception_state_dict
from gcd_tpu.models.lpips import LPIPS as JLPIPS
from gcd_tpu.models.lpips import load_lpips_params
from gcd_tpu.utils.config import instantiate_from_config as j_instantiate
from gcd_tpu_torch.engine.build import engine_from_config
from gcd_tpu_torch.io.convert import (
    inception_state_dict_from_flax,
    lpips_state_dict_from_flax,
    state_dict_from_flax,
)
from gcd_tpu_torch.models.inception import InceptionV3
from gcd_tpu_torch.models.lpips import LPIPS, load_lpips, lpips_state_dict
from gcd_tpu_torch.utils.config import instantiate_from_config, load_config
from gcd_tpu_torch.utils.resize import resize
from tests.torch_port_helpers import (
    TINY_CONFIG,
    engine_params,
    engine_state_dict,
    fill_params,
    rel_l2,
    tiny_batch,
)

VGG_CONVS = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
             (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512),
             (24, 512, 512), (26, 512, 512), (28, 512, 512)]
LIN_CHANNELS = [64, 128, 256, 512, 512]


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def lpips_files(tmp_path_factory):
    """A torchvision-named VGG16 state dict (He-scaled convs) and lpips lins
    (positive), written as .pth files."""
    rng = np.random.default_rng(0)
    vgg = {}
    for i, cin, cout in VGG_CONVS:
        vgg[f"features.{i}.weight"] = torch.from_numpy(
            rng.normal(0, (2.0 / (9 * cin)) ** 0.5, (cout, cin, 3, 3)).astype(np.float32))
        vgg[f"features.{i}.bias"] = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(0.05, 1.0, (1, c, 1, 1)).astype(np.float32)) for i, c in enumerate(LIN_CHANNELS)}
    root = tmp_path_factory.mktemp("lpips")
    torch.save(vgg, root / "vgg16.pth")
    torch.save(lins, root / "vgg.pth")
    return str(root / "vgg16.pth"), str(root / "vgg.pth")


@pytest.mark.parametrize("with_lins", [True, False])
def test_lpips_matches_jax(lpips_files, with_lins):
    """The same two files through JAX's load_lpips_params and the port's
    load_lpips (the lins ones without the second file); LPIPS(x, x) = 0;
    JAX's tree carried across by lpips_state_dict_from_flax is the port's
    loader's state dict."""
    vgg, lins = lpips_files[0], lpips_files[1] if with_lins else None
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (4, 64, 96, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, a.shape), -1, 1).astype(np.float32)
    jparams = load_lpips_params(vgg, lins)
    ref = np.asarray(jax.jit(lambda p, a, b: JLPIPS().apply({"params": p}, a, b))(jparams, a, b))
    model = load_lpips(vgg, lins, device="cpu")
    with torch.no_grad():
        out = model(_nchw(a), _nchw(b)).numpy()
        same = model(_nchw(a), _nchw(a)).numpy()
    assert out.shape == (4,) and ref.min() > 1e-3
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(same, 0.0)
    carried = lpips_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    expected = lpips_state_dict(vgg, lins)
    assert sorted(carried) == sorted(expected) == sorted(LPIPS().state_dict())
    for k, v in expected.items():
        assert torch.equal(carried[k], v), k


def test_validation_lpips_matches_jax(lpips_files):
    """engine.validation_metrics with an LPIPS network against JAX's with
    lpips_params, on the tiny engine: the same weights, the same latent
    noise (normal(split(key)[0])), 2 steps. The frames agree within 1e-3
    (tests/test_torch_slice.py), so the metrics within 1e-3 relative."""
    cfg = load_config(TINY_CONFIG)["model"]
    batch = tiny_batch(3, 32, 48, 8)
    batch["jpg"] = batch["cond_frames_without_noise"]
    jeng = j_instantiate(cfg)
    params = engine_params(jeng, batch, 20)
    key = jax.random.PRNGKey(3)
    sample_video = jeng.sample_video
    jeng.sample_video = jax.jit(lambda p, b, k, decoding_t=None: sample_video(
        p, b, k, num_steps=2, decoding_t=decoding_t))
    ref = jeng.validation_metrics(params, jax.tree_util.tree_map(jnp.asarray, batch), key,
                                  lpips_params=load_lpips_params(*lpips_files))
    noise = np.array(jax.random.normal(jax.random.split(key)[0], (3, 4, 6, 4), jnp.float32))

    emb_models = cfg["params"]["conditioner_config"]["params"]["emb_models"]
    engine = engine_from_config(cfg, device="cpu", dtype=torch.float32,
                                state_dict=engine_state_dict(params, emb_models, 30))
    engine.sampler.num_steps = 2
    got = engine.validation_metrics({k: torch.from_numpy(v) for k, v in batch.items()},
                                    noise=torch.from_numpy(noise),
                                    lpips=load_lpips(*lpips_files, device="cpu"))
    assert sorted(got) == sorted(ref) == ["val/lpips", "val/psnr", "val/ssim"]
    assert ref["val/lpips"] > 1e-3
    for k in got:
        assert abs(got[k] - ref[k]) <= 1e-3 * abs(ref[k]), (k, got[k], ref[k])


DD = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], z_channels=4,
          double_z=True, in_channels=3, out_ch=3, resolution=32, dropout=0.0)


@pytest.mark.parametrize("flags", [{}, {"perceptual_weight_on_inputs": 0.5,
                                        "scale_input_to_tgt_size": True}])
def test_latent_lpips_matches_jax(lpips_files, flags):
    """LatentLPIPS over the tiny KL autoencoder's decoder (the same config
    dict on both sides), its weights and LPIPS's passed per call as on the
    JAX side; with the scale flag the (48, 20) inputs are resized to the
    decoder's 32 x 32 with JAX's bicubic (one axis shrinks). Without the
    weights it raises."""
    cfg = {"target": "sgm.modules.autoencoding.losses.lpips.LatentLPIPS",
           "params": {"decoder_config": {"target": "sgm.models.autoencoder.AutoencoderKLModeOnly",
                                         "params": {"embed_dim": 4, "ddconfig": DD}},
                      "perceptual_weight": 1.0, "latent_weight": 0.7, **flags}}
    jm, m = j_instantiate(cfg), instantiate_from_config(cfg)
    dec = fill_params(jax.eval_shape(lambda: jm.decoder.init(jax.random.PRNGKey(0),
                                                             img_hw=(32, 32))), 4)
    jlp = load_lpips_params(*lpips_files)
    rng = np.random.default_rng(5)
    za = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    zb = (za + 0.3 * rng.normal(size=za.shape)).astype(np.float32)
    images = rng.uniform(-1, 1, (2, 48, 20, 3)).astype(np.float32)
    ref_loss, ref_log = jm(jnp.asarray(za), jnp.asarray(zb), jnp.asarray(images),
                           decoder_params=dec, lpips_params=jlp)
    loss, log = m(_nchw(za), _nchw(zb), _nchw(images), decoder_params=state_dict_from_flax(dec),
                  lpips_params=lpips_state_dict(*lpips_files))
    assert sorted(log) == sorted(ref_log)
    for k in log:
        assert abs(float(log[k]) - float(ref_log[k])) <= 1e-4 * abs(float(ref_log[k])), k
    assert abs(float(loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    with pytest.raises(ValueError, match="decoder_params and lpips_params"):
        m(_nchw(za), _nchw(zb))


@pytest.mark.parametrize("method,jax_method", [("linear", "bilinear"), ("cubic", "bicubic")])
def test_resize_matches_jax(method, jax_method):
    """utils/resize.py against jax.image.resize, one axis shrinking and one
    growing."""
    x = np.random.default_rng(6).normal(size=(2, 40, 17, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 23, 30, 3), jax_method))
    out = resize(torch.from_numpy(x), (23, 30), method).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _fid_state_dict(seed):
    """A pytorch-fid-named InceptionV3 state dict: He-scaled convs, BatchNorm
    weights near 1, running variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in InceptionV3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = v
            continue
        if k.endswith("running_var"):
            arr = rng.uniform(0.5, 2.0, v.shape)
        elif k.endswith("bn.weight"):
            arr = 1.0 + 0.1 * rng.normal(size=v.shape)
        elif v.dim() == 4:
            arr = rng.normal(0, (2.0 / np.prod(v.shape[1:])) ** 0.5, v.shape)
        else:
            arr = rng.normal(0, 0.1, v.shape)
        out[k] = torch.from_numpy(arr.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def fid_weights():
    sd = _fid_state_dict(7)
    template = jax.eval_shape(lambda: JInceptionV3().init(jax.random.PRNGKey(0),
                                                          jnp.zeros((1, 32, 32, 3))))
    variables, missing = convert_fid_inception_state_dict(
        {k: v.numpy() for k, v in sd.items()}, dict(template))
    assert missing == []
    return sd, variables


@pytest.mark.parametrize("kwargs", [{"output_blocks": (0, 1, 2, 3)}, {},
                                    {"normalize_input": True}])
def test_inception_matches_jax(fid_weights, kwargs):
    """The same pytorch-fid state dict, loaded strictly by the port and
    converted by JAX's convert_fid_inception_state_dict, on (2, 128, 384)
    frames (299: the height grows, the width shrinks)."""
    sd, variables = fid_weights
    x = np.random.default_rng(8).uniform(0, 1, (2, 128, 384, 3)).astype(np.float32)
    jm = JInceptionV3(**kwargs)
    ref = jax.jit(jm.apply)(variables, jnp.asarray(x))
    model = InceptionV3(**kwargs)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = model.eval()(_nchw(x))
    refs, outs = (ref, out) if isinstance(ref, list) else ([ref], [out])
    assert len(outs) == len(refs) == len(kwargs.get("output_blocks", (3,)))
    for r, o in zip(refs, outs):
        r = np.asarray(r)
        o = o.numpy() if o.dim() == 2 else o.permute(0, 2, 3, 1).numpy()
        assert o.shape == r.shape
        assert rel_l2(o, r) <= 1e-4
    if not isinstance(ref, list):
        assert out.shape == (2, 2048)


def test_inception_state_dict_from_flax_round_trip(fid_weights):
    """JAX's variables carried back by inception_state_dict_from_flax are
    the state dict they came from, the classifier aside (JAX builds no fc)."""
    sd, variables = fid_weights
    back = inception_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    kept = {k for k in sd if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(kept - {"fc.weight", "fc.bias"})
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    assert len(_iter_tree_paths(dict(variables)["batch_stats"])) == sum(
        k.endswith(("running_mean", "running_var")) for k in back)
