"""The port's text towers and the other embedders against the JAX package:
CLIPTextTower (causal, both GELUs, every output), the T5 position bucket
(exact), T5Encoder (gated and ReLU), byt5_tokenize (exact), each of the ten
embedders the port lacked (the stochastic ones with JAX's draws passed in),
the GeneralConditioner's tuple routing and batch_uc, its second pass for
stochastic embedders, the local-only tokenizers' RuntimeError, and every
`sgm.*` name of the JAX registry resolving in the port's.

fp32 on the CPU, JAX at highest matmul precision, weights carried by the
weight bridge (gcd_tpu_torch.io.convert) and loaded with strict=True; the
modules chain matmuls, LayerNorms / RMSNorms and softmaxes whose fp32 sums
differ only in order (~1e-6 relative), so the 1e-4 bound catches any wrong
key, layout, mask, bias or rounding point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcd_tpu.models import embedders as jemb
from gcd_tpu.models import text_towers as jtt
from gcd_tpu_torch.io.convert import (
    conditioner_state_dict_from_flax,
    embedder_state_dict_from_flax,
    hf_clip_text_to_openclip_sd,
    openclip_text_rename,
    state_dict_from_flax,
    t5_rename,
)
from gcd_tpu_torch.models import embedders, text_towers
from tests.torch_port_helpers import TINY_DD, fill_params, rel_l2
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
S = 9
CLIP_SMALL = dict(width=32, layers=3, heads=4, vocab_size=64, max_length=S)
T5_SMALL = dict(d_model=32, d_ff=48, num_layers=2, num_heads=4, d_kv=8, vocab_size=64)


def _key(i=0):
    return jax.random.PRNGKey(i)


def _params(jmod, seed, *args, rngs=None, **kwargs):
    """Seeded values for the module's params (tests/torch_port_helpers.py
    fill_params), at a call with the given rng streams."""
    rngs = rngs or {}
    shapes = jax.eval_shape(lambda: jmod.init({"params": _key(), **rngs}, *args, **kwargs))
    return fill_params(shapes.get("params", {}), seed)


def _tokens(seed, vocab=64, rows=2):
    """(rows, S) int32 tokens whose largest id (the eot) is unique per row."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, vocab - 1, (rows, S)).astype(np.int32)
    for r in range(rows):
        tok[r, rng.integers(2, S)] = vocab - 1
    return tok


def _port(cls, params, **kwargs):
    mod = cls(**kwargs)
    mod.load_state_dict(embedder_state_dict_from_flax(mod, params), strict=True)
    return mod.eval()


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("quick_gelu,output_dim", [(False, 24), (True, None)])
def test_clip_text_tower(quick_gelu, output_dim):
    tok = _tokens(0)
    kw = dict(vocab_size=64, width=32, layers=3, heads=4, context_length=S,
              output_dim=output_dim, quick_gelu=quick_gelu)
    jmod = jtt.CLIPTextTower(**kw)
    params = _params(jmod, 1, jnp.asarray(tok))
    ref = jmod.apply({"params": params}, jnp.asarray(tok))
    port = text_towers.CLIPTextTower(**kw)
    port.load_state_dict({openclip_text_rename(k): v
                          for k, v in state_dict_from_flax(params).items()}, strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(tok))
    assert set(out) == set(ref)
    for key in ("last", "penultimate", "normed", "normed_penultimate", "pooled"):
        assert rel_l2(_np(out[key]), ref[key]) <= TOL, key
    assert len(out["hidden"]) == len(ref["hidden"]) == 4
    for got, want in zip(out["hidden"], ref["hidden"]):
        assert rel_l2(_np(got), want) <= TOL
    # The causal mask: a later token does not reach an earlier position.
    tok2 = tok.copy()
    tok2[:, -1] = (tok2[:, -1] + 1) % 63
    with torch.no_grad():
        out2 = port(torch.from_numpy(tok2))
    assert torch.equal(out2["last"][:, :-1], out["last"][:, :-1])


def test_hf_and_openclip_names_round_trip():
    """A transformers CLIPTextModel's own state dict under `transformer.`
    loads into FrozenCLIPEmbedder with strict=True, re-keyed by the port's
    copy of hf_clip_text_to_openclip_sd (the JAX package's arrays, exactly),
    gives the HF model's outputs, and the port's state dict loads back."""
    from transformers import CLIPTextConfig, CLIPTextModel

    from gcd_tpu.io.convert import hf_clip_text_to_openclip_sd as jax_hf_to_openclip

    torch.manual_seed(0)
    hf = CLIPTextModel(CLIPTextConfig(
        vocab_size=64, hidden_size=32, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, max_position_embeddings=S, hidden_act="quick_gelu",
        eos_token_id=63)).eval()
    sd = hf.state_dict()
    want = jax_hf_to_openclip({k: v.numpy() for k, v in sd.items()})
    got = hf_clip_text_to_openclip_sd(dict(sd))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    kwargs = dict(width=32, layers=3, heads=4, max_length=S, vocab_size=64,
                  always_return_pooled=True)
    port = embedders.FrozenCLIPEmbedder(**kwargs)
    port.load_state_dict({"transformer." + k: v for k, v in sd.items()}, strict=True)
    tok = _tokens(3)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(tok).long())
        z, pooled = port.eval()(torch.from_numpy(tok))
    assert rel_l2(_np(z), ref.last_hidden_state.numpy()) <= TOL
    assert rel_l2(_np(pooled), ref.pooler_output.numpy()) <= TOL
    embedders.FrozenCLIPEmbedder(**kwargs).load_state_dict(port.state_dict(), strict=True)


def test_t5_relative_position_bucket_is_exact():
    rel = np.arange(-300, 301).reshape(1, -1)
    for buckets, distance in ((32, 128), (8, 16), (32, 20)):
        want = np.asarray(jtt._t5_relative_position_bucket(jnp.asarray(rel), buckets, distance))
        got = text_towers.t5_relative_position_bucket(torch.from_numpy(rel), buckets, distance)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gated", [True, False])
def test_t5_encoder(gated):
    tok = _tokens(2)
    kw = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4,
              relative_attention_num_buckets=8, relative_attention_max_distance=16,
              gated_ff=gated)
    jmod = jtt.T5Encoder(**kw)
    params = _params(jmod, 3, jnp.asarray(tok))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(tok)))
    port = text_towers.T5Encoder(**kw)
    sd = {t5_rename(k): v for k, v in state_dict_from_flax(params).items()}
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(tok))
    assert out.dtype == torch.float32
    assert rel_l2(out.numpy(), ref) <= TOL


def test_byt5_tokenize_is_exact():
    texts = ["hi", "a" * 200, "naïve café ✓", ""]
    want = np.asarray(jtt.byt5_tokenize(texts, max_length=16))
    got = text_towers.byt5_tokenize(texts, max_length=16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# --- The ten embedders ------------------------------------------------------

@pytest.mark.parametrize("name,kwargs,layer_outputs", [
    ("FrozenT5Embedder", T5_SMALL, None),
    ("FrozenCLIPEmbedder", dict(width=32, layers=3, heads=4, max_length=S,
                                vocab_size=64, layer="last"), None),
    ("FrozenCLIPEmbedder", dict(width=32, layers=3, heads=4, max_length=S,
                                vocab_size=64, layer="pooled"), None),
    ("FrozenCLIPEmbedder", dict(width=32, layers=3, heads=4, max_length=S, vocab_size=64,
                                layer="hidden", layer_idx=1, always_return_pooled=True), 2),
    ("FrozenOpenCLIPEmbedder", dict(CLIP_SMALL, output_dim=24, layer="last"), None),
    ("FrozenOpenCLIPEmbedder", dict(CLIP_SMALL, output_dim=24, layer="penultimate"), None),
    ("FrozenOpenCLIPEmbedder2", dict(CLIP_SMALL, output_dim=24, layer="penultimate"), None),
    ("FrozenOpenCLIPEmbedder2", dict(CLIP_SMALL, output_dim=24, layer="last", legacy=False,
                                     always_return_pooled=True), 2),
])
def test_text_embedder(name, kwargs, layer_outputs):
    tok = _tokens(4)
    jmod = getattr(jemb, name)(**kwargs)
    params = _params(jmod, 5, jnp.asarray(tok))
    ref = jmod.apply({"params": params}, jnp.asarray(tok))
    port = _port(getattr(embedders, name), params, **kwargs)
    with torch.no_grad():
        out = port(torch.from_numpy(tok))
    refs = ref if layer_outputs else (ref,)
    outs = out if layer_outputs else (out,)
    assert len(outs) == len(refs)
    for got, want in zip(outs, refs):
        assert tuple(got.shape) == tuple(want.shape)
        assert rel_l2(_np(got), want) <= TOL


def test_byt5_embedder_from_strings():
    texts = ["a red ball rolls left", "camera orbits 30°"]
    kw = dict(T5_SMALL, vocab_size=384, max_length=S + 7)
    jmod = jemb.FrozenByT5Embedder(**kw)
    params = _params(jmod, 6, texts)
    ref = np.asarray(jmod.apply({"params": params}, texts))
    port = _port(embedders.FrozenByT5Embedder, params, **kw)
    out = port(texts)
    assert out.shape == (2, S + 7, 32)
    assert rel_l2(out.numpy(), ref) <= TOL


def test_identity_and_class_embedder():
    x = np.random.default_rng(7).normal(size=(3, 5)).astype(np.float32)
    assert torch.equal(embedders.IdentityEncoder()(torch.from_numpy(x)), torch.from_numpy(x))
    ids = np.array([0, 3, 9], np.int32)
    for seq in (False, True):
        kw = dict(embed_dim=8, n_classes=10, add_sequence_dim=seq)
        jmod = jemb.ClassEmbedder(**kw)
        params = _params(jmod, 8, jnp.asarray(ids))
        ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
        port = _port(embedders.ClassEmbedder, params, **kw)
        out = port(torch.from_numpy(ids))
        assert out.shape == ref.shape and rel_l2(_np(out), ref) <= TOL
    assert (port.get_unconditional_conditioning_value()
            == jmod.get_unconditional_conditioning_value())


@pytest.mark.parametrize("kwargs,shape", [
    (dict(method="bilinear", multiplier=0.5), (2, 32, 48, 3)),
    (dict(method="area", n_stages=2, multiplier=0.5, out_channels=5, bias=True), (2, 32, 48, 3)),
    (dict(method="bicubic", multiplier=0.75, remap_output=True, kernel_size=3), (2, 16, 24, 3)),
    (dict(method="nearest", multiplier=0.5, wrap_video=True), (2, 3, 16, 24, 3)),
])
def test_spatial_rescaler(kwargs, shape):
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    jmod = jemb.SpatialRescaler(**kwargs)
    params = _params(jmod, 10, jnp.asarray(x))
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    port = _port(embedders.SpatialRescaler, params, **kwargs)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape
    assert rel_l2(out.numpy(), ref) <= TOL


class _Draws:
    """Records the values jax.random.normal / randint return during an
    eager JAX call (the stochastic embedders' draws)."""

    def __init__(self, monkeypatch):
        self.values = []
        normal, randint = jax.random.normal, jax.random.randint

        def rec(fn):
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.values.append(np.asarray(out))
                return out
            return wrapped

        monkeypatch.setattr(jax.random, "normal", rec(normal))
        monkeypatch.setattr(jax.random, "randint", rec(randint))


def test_gaussian_encoder_with_jax_draws(monkeypatch):
    x = np.random.default_rng(11).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    for flatten in (True, False):
        jmod = jemb.GaussianEncoder(ddconfig=TINY_DD, flatten_output=flatten)
        rngs = {"gaussian": _key(1)}
        params = _params(jmod, 12, jnp.asarray(x), rngs=rngs)
        draws = _Draws(monkeypatch)
        ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), rngs=rngs))
        port = _port(embedders.GaussianEncoder, params, ddconfig=TINY_DD,
                     flatten_output=flatten)
        with torch.no_grad():
            out = port(torch.from_numpy(x), noise=torch.from_numpy(draws.values[-1]))
        assert out.shape == ref.shape == ((2, 256, 4) if flatten else (2, 16, 16, 4))
        assert rel_l2(out.numpy(), ref) <= TOL
        monkeypatch.undo()


def test_low_scale_encoder_with_jax_draws(monkeypatch):
    x = np.random.default_rng(13).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    kw = dict(model_config={"target": "sgm.models.autoencoder.AutoencoderKL",
                            "params": {"embed_dim": 4, "ddconfig": TINY_DD}},
              output_size=8, scale_factor=0.5, max_noise_level=250)
    jmod = jemb.LowScaleEncoder(**kw)
    rngs = {"gaussian": _key(1), "noise_level": _key(2), "q_noise": _key(3)}
    params = _params(jmod, 14, jnp.asarray(x), rngs=rngs)
    z8 = np.random.default_rng(15).normal(size=(2, 16, 16, 4)).astype(np.float32)
    params.update(_params(jmod, 16, jnp.asarray(z8), method=jmod.decode))
    draws = _Draws(monkeypatch)
    ref_z, ref_level = jmod.apply({"params": params}, jnp.asarray(x), rngs=rngs)
    posterior, level, q_noise = draws.values[-3:]
    port = _port(embedders.LowScaleEncoder, params, **kw)
    with torch.no_grad():
        z, lv = port(torch.from_numpy(x), noise=torch.from_numpy(posterior),
                     noise_level=torch.from_numpy(level), q_noise=torch.from_numpy(q_noise))
        dec = port.decode(torch.from_numpy(z8))
    ref_dec = np.asarray(jmod.apply({"params": params}, jnp.asarray(z8), method=jmod.decode))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(ref_level))
    assert z.shape == ref_z.shape == (2, 8, 8, 4)
    assert rel_l2(z.numpy(), ref_z) <= TOL
    assert dec.shape == ref_dec.shape and rel_l2(dec.numpy(), ref_dec) <= TOL
    # From a generator: the three draws in order, fresh each call.
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a, la = port(torch.from_numpy(x), generator=gen)
        b, lb = port(torch.from_numpy(x), generator=gen)
    assert not torch.equal(a, b) and la.shape == (2,) and int(la.max()) < 250


# --- The conditioner --------------------------------------------------------

def _text_conditioner_models():
    return [
        {"input_key": "txt", "target": "sgm.modules.encoders.modules.FrozenOpenCLIPEmbedder2",
         "params": dict(CLIP_SMALL, output_dim=24, legacy=False, always_return_pooled=True)},
        {"input_key": "cls", "target": "sgm.modules.encoders.modules.ClassEmbedder",
         "params": {"embed_dim": 8, "n_classes": 10}},
    ]


def test_conditioner_routes_tuples_and_batch_uc():
    """A tuple output (crossattn tokens and a pooled vector) and a class
    vector; c from one batch, uc from another with the text zeroed, as
    JAX's get_unconditional_conditioning makes them."""
    models = _text_conditioner_models()
    jcond = jemb.GeneralConditioner(emb_models=models)
    batch_c = {"txt": jnp.asarray(_tokens(17)), "cls": jnp.asarray([1, 4], jnp.int32)}
    batch_uc = {"txt": jnp.asarray(_tokens(18)), "cls": jnp.asarray([9, 9], jnp.int32)}
    params = _params(jcond, 19, batch_c)
    ref_c, ref_uc = jcond.apply({"params": params}, batch_c, batch_uc, ["txt"],
                                method=jcond.get_unconditional_conditioning)
    port = embedders.GeneralConditioner(models)
    port.load_state_dict(conditioner_state_dict_from_flax(port, params), strict=True)
    tb = lambda b: {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}  # noqa: E731
    with torch.no_grad():
        c, uc = port.eval().get_unconditional_conditioning(
            tb(batch_c), ["txt"], batch_uc=tb(batch_uc))
    for got, want in ((c, ref_c), (uc, ref_uc)):
        assert set(got) == set(want) == {"crossattn", "vector"}
        assert got["vector"].shape == (2, 32)
        for key in want:
            if np.any(want[key]):
                assert rel_l2(_np(got[key]), want[key]) <= TOL, key
    assert not uc["crossattn"].any() and not np.any(ref_uc["crossattn"])


def test_conditioner_drops_each_output_apart():
    """Under train with a ucg_rate, each output of a tuple embedder is kept
    by its own mask, as JAX draws one an output: crossattn and the pooled
    vector drop apart, from masks given as (N, K) or drawn in draw_keep's
    layout."""
    models = _text_conditioner_models()[:1]
    models[0]["ucg_rate"] = 0.5
    port = embedders.GeneralConditioner(models).eval()
    torch.manual_seed(1)
    for p in port.parameters():
        torch.nn.init.normal_(p, std=0.2)
    batch = {"txt": torch.from_numpy(_tokens(21, rows=4))}
    keep = torch.tensor([[1, 1], [1, 0], [0, 1], [0, 0]], dtype=torch.bool)
    with torch.no_grad():
        full = port(batch)
        given = port(batch, train=True, ucg_keep={0: keep})
        drawn = port(batch, train=True, generator=torch.Generator().manual_seed(4))
        with pytest.raises(ValueError, match="keep masks"):
            port(batch, train=True, ucg_keep={0: keep[:, 0]})
    drawn_keep = port.draw_keep(4, torch.Generator().manual_seed(4))[0]
    assert drawn_keep.shape == (4, 2)
    for out, mask in ((given, keep), (drawn, drawn_keep)):
        for col, name in enumerate(("crossattn", "vector")):
            for row in range(4):
                if mask[row, col]:
                    assert torch.equal(out[name][row], full[name][row])
                else:
                    assert not out[name][row].any() and full[name][row].any()


def test_conditioner_draws_c_and_uc_apart():
    """A stochastic embedder takes a pass for c and one for uc (the JAX
    package's two calls): different draws from the generator, in that
    order."""
    models = [{"input_key": "frames", "target": "sgm.modules.encoders.modules.GaussianEncoder",
               "params": {"ddconfig": TINY_DD}}]
    port = embedders.GeneralConditioner(models).eval()
    assert port.stochastic
    x = torch.rand(2, 32, 32, 3) * 2 - 1
    with torch.no_grad():
        c, uc = port.get_unconditional_conditioning(
            {"frames": x}, generator=torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(3)
        first = port.embedders[0](x, generator=gen)
        second = port.embedders[0](x, generator=gen)
    assert torch.equal(c["crossattn"], first) and torch.equal(uc["crossattn"], second)
    assert not torch.equal(first, second)


@pytest.mark.parametrize("name", ["FrozenT5Embedder", "FrozenCLIPEmbedder",
                                  "FrozenOpenCLIPEmbedder"])
def test_strings_without_tokenizer_assets_raise(name, monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    kwargs = T5_SMALL if name == "FrozenT5Embedder" else dict(CLIP_SMALL)
    port = getattr(embedders, name)(**kwargs)
    with pytest.raises(RuntimeError, match="not available locally"):
        port(["a red ball"])


def test_every_jax_registry_name_resolves():
    import gcd_tpu.registry  # noqa: F401
    from gcd_tpu.utils.config import _REGISTRY
    from gcd_tpu_torch.utils.config import get_obj_from_str

    names = sorted(k for k in _REGISTRY if k.startswith("sgm."))
    assert len(names) == 73
    for name in names:
        assert isinstance(get_obj_from_str(name), type), name
