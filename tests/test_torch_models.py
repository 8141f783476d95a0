"""The port's VGGSmall, ResNet-50, AlexNet and LSTM LM against the flax
models, on the CPU; the layers they share (strided ``"SAME"`` conv and
pool, GroupNorm, the space-to-depth stem) and the registry.

Each model's params are drawn by the port and carried to flax with
``convert.to_flax``; the same numpy inputs made from a seed go through
both, and the logits and the loss gradients are compared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from mpit_tpu import models as ref_models
from mpit_tpu.ops.stem import space_to_depth_conv as ref_s2d
from mpit_tpu.parallel import EASGDTrainer as JaxEASGDTrainer
from mpit_tpu.parallel.common import cross_entropy_loss as jax_xent
from mpit_tpu_torch import models
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models.layers import GroupNorm, max_pool, same_pads
from mpit_tpu_torch.models.layers import Conv as PortConv
from mpit_tpu_torch.ops.stem import space_to_depth_conv
from mpit_tpu_torch.optim import SGD
from mpit_tpu_torch.parallel import EASGDTrainer
from mpit_tpu_torch.parallel.common import cross_entropy_loss

# f32: both sides compute in float32 and sum in other orders; GroupNorm's
# statistics over up to 4,096 elements and ResNet's 2,304-element 3x3
# contractions move the last bits: seen up to 1.8e-5 on logits of size 3.
# 5e-5 leaves room.
F32_TOL = dict(rtol=5e-5, atol=5e-5)
# f32 gradients, per leaf in L2 norm: within 1e-5 of the reference's, but
# where a ReLU's input lies within that error of zero the two sides may take
# different branches; with these inputs ResNet's last block has one at
# 1.2e-6, which moves the gradients of every layer below it by up to 3e-3.
F32_GRAD_REL = 1e-2
# bf16 logits: activations rounded to bf16 at every layer, at other points
# in the two frameworks (XLA fuses elementwise chains in f32 before one
# rounding); seen up to 0.031 on ResNet's logits of size 3.
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# bf16 gradients: at a batch of 2 the reference's own bf16 gradients lie
# up to 27% (in L2 norm, per leaf) from its f32 ones, after the
# cancellations in softmax - onehot and in GroupNorm's backward; the
# port's lie within 1.33x that distance of the reference's bf16 ones. A
# leaf must lie within 2x that distance, plus 2% of its norm.
BF16_GRAD_NOISE, BF16_GRAD_FLOOR = 2.0, 0.02

RNG = np.random.default_rng(0)
IMG32 = RNG.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
IMG64 = RNG.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
TOKENS = RNG.integers(0, 50, (2, 8)).astype(np.int32)
LABELS = {10: RNG.integers(0, 10, 2).astype(np.int32),
          1000: RNG.integers(0, 1000, 2).astype(np.int32),
          "tok": RNG.integers(0, 50, (2, 8)).astype(np.int32)}
LSTM_TINY = dict(vocab_size=50, embed_dim=16, hidden=32, num_layers=2)

# case -> (registry name, reference kwargs, port-only kwargs, x, labels)
CASES = {
    "vgg": ("vgg", {}, {}, IMG32, 10),
    "resnet-conv": ("resnet50", dict(stage_sizes=(1, 1, 1, 1)),
                    dict(in_shape=(64, 64, 3)), IMG64, 1000),
    "resnet-s2d": ("resnet50", dict(stage_sizes=(1, 1, 1, 1), stem="space_to_depth"),
                   dict(in_shape=(64, 64, 3)), IMG64, 1000),
    "alexnet-conv": ("alexnet", {}, dict(in_shape=(64, 64, 3)), IMG64, 1000),
    "alexnet-s2d": ("alexnet", dict(stem="space_to_depth"),
                    dict(in_shape=(64, 64, 3)), IMG64, 1000),
    "lstm": ("lstm", LSTM_TINY, {}, TOKENS, "tok"),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _port(case, dt):
    name, kw, port_kw, _, _ = CASES[case]
    return models.get_model(name, compute_dtype=DTYPES[dt][1], device="cpu",
                            **kw, **port_kw)


@functools.lru_cache(maxsize=None)
def _params(case):
    """The port's initial params for ``case`` (as a flax numpy tree)."""
    return to_flax(_port(case, "f32").init(torch.Generator().manual_seed(0)))


@functools.lru_cache(maxsize=None)
def _reference(case, dt):
    """The flax model's logits and loss gradients on ``case``'s inputs."""
    name, kw, _, x, labels = CASES[case]
    jm = ref_models.get_model(name, compute_dtype=DTYPES[dt][0], **kw)
    y = LABELS[labels]

    def loss(p):
        logits = jm.apply({"params": p}, x)
        return jax_xent(logits, y), logits

    params = jax.tree.map(jnp.asarray, _params(case))
    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(logits), jax.tree.map(lambda g: np.asarray(g, np.float32), grads)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_grads_match_flax(case, dt):
    _, _, _, x, labels = CASES[case]
    ref_logits, ref_grads = _reference(case, dt)
    pm = _port(case, dt)
    params = from_flax(_params(case), device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(LABELS[labels])
    logits = pm.apply(params, xt)
    assert logits.dtype == torch.float32 and logits.shape == ref_logits.shape
    tol = F32_TOL if dt == "f32" else BF16_TOL
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, **tol)

    grads = to_flax(torch.func.grad(
        lambda p: cross_entropy_loss(pm.apply(p, xt), yt))(params))
    assert jax.tree.structure(grads) == jax.tree.structure(ref_grads)
    if dt == "f32":
        for g, r in zip(jax.tree.leaves(grads), jax.tree.leaves(ref_grads)):
            assert np.linalg.norm(g - r) <= F32_GRAD_REL * np.linalg.norm(r)
        return
    _, ref_f32 = _reference(case, "f32")
    for g, r, r32 in zip(*map(jax.tree.leaves, (grads, ref_grads, ref_f32))):
        noise = np.linalg.norm(r - r32)
        assert np.linalg.norm(g - r) <= (BF16_GRAD_NOISE * noise
                                         + BF16_GRAD_FLOOR * np.linalg.norm(r))


@pytest.mark.parametrize("name, kw, port_kw, x_shape", [
    ("resnet50", {}, {}, (1, 224, 224, 3)),
    ("resnet50", dict(stem="space_to_depth"), {}, (1, 224, 224, 3)),
    ("alexnet", {}, {}, (1, 224, 224, 3)),
    ("alexnet", dict(stem="space_to_depth"), {}, (1, 224, 224, 3)),
    ("vgg", {}, {}, (1, 32, 32, 3)),
    ("lstm", {}, {}, (1, 8)),
], ids=["resnet50", "resnet50-s2d", "alexnet", "alexnet-s2d", "vgg", "lstm"])
def test_full_size_trees_equal_the_flax_trees(name, kw, port_kw, x_shape):
    """Leaf names and shapes at the presets' full size, flax's by
    ``jax.eval_shape`` (no compute); the port's without drawing them."""
    dtype = jnp.int32 if len(x_shape) == 2 else jnp.float32
    ref = jax.eval_shape(lambda: ref_models.get_model(name, **kw).init(
        jax.random.key(0), jnp.zeros(x_shape, dtype)))["params"]
    ref = {"/".join(k.key for k in path): tuple(v.shape)
           for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    port = models.get_model(name, device="cpu", **kw, **port_kw)
    got = {n.replace(".", "/"): tuple(p.shape[2:] + p.shape[1::-1]) if p.dim() == 4
           else tuple(p.shape) for n, p in port.named_parameters()}
    assert got == ref
    expect = {"resnet50": 25_557_032, "alexnet": 61_100_840, "vgg": 3_249_098,
              "lstm": 11_364_112}[name]
    assert sum(p.numel() for p in port.parameters()) == expect


@pytest.mark.parametrize("size", [7, 8, 9, 16])
def test_strided_same_conv_and_pool_equal_flax_bit_for_bit(size):
    """A 3-tap stride-2 ``"SAME"`` conv and max-pool over even and odd
    sizes: integer inputs make every sum exact, so the windows are
    compared bit for bit (a window shifted by one cannot pass)."""
    rng = np.random.default_rng(size)
    x = rng.integers(-4, 5, (2, size, size + 1, 3)).astype(np.float32)
    conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME", use_bias=False,
                    dtype=jnp.float32)
    params = conv.init(jax.random.key(0), x)["params"]
    kernel = rng.integers(-3, 4, params["kernel"].shape).astype(np.float32)
    want = np.asarray(conv.apply({"params": {"kernel": kernel}}, x))
    port = PortConv(3, 5, 3, torch.float32, "cpu", stride=2, use_bias=False)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.func.functional_call(
        port, {"kernel": from_flax({"k": kernel}, device="cpu")["k"]}, (nchw,))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).detach().numpy(), want)
    pool_want = np.asarray(fnn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"))
    pool = max_pool(nchw, 3, 2, "SAME").permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(pool, pool_want)
    assert same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    # PyTorch's symmetric padding=1 differs wherever lax pads (0, 1)
    sym = F.max_pool2d(nchw, 3, 2, padding=1).permute(0, 2, 3, 1).numpy()
    assert (sym.shape == pool.shape) and (size % 2 == 1 or not np.array_equal(sym, pool))


@pytest.mark.parametrize("features, groups", [(64, 32), (256, 32), (12, 4)])
def test_group_norm_equals_flax(features, groups):
    rng = np.random.default_rng(features)
    x = rng.normal(1.0, 2.0, (2, 5, 6, features)).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=groups, dtype=jnp.float32)
    params = {"scale": rng.normal(1, 0.1, features).astype(np.float32),
              "bias": rng.normal(0, 0.1, features).astype(np.float32)}
    want = np.asarray(gn.apply({"params": params}, x))
    port = GroupNorm(features, torch.float32, "cpu", num_groups=groups)
    got = torch.func.functional_call(
        port, {k: torch.from_numpy(v) for k, v in params.items()},
        (torch.from_numpy(x).permute(0, 3, 1, 2),))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), want,
                               **F32_TOL)
    with pytest.raises(ValueError, match="does not divide"):
        GroupNorm(features + 1, torch.float32, "cpu", num_groups=groups)


@pytest.mark.parametrize("k, s, p, size", [(7, 2, 3, 64), (11, 4, 2, 64), (11, 4, 2, 32)],
                         ids=["resnet-stem", "alexnet-stem", "alexnet-stem-32"])
def test_space_to_depth_conv_equals_the_strided_conv(k, s, p, size):
    """The s2d form equals the port's strided conv and the reference's s2d
    conv on the same input and kernel (f32; the zero taps change the order
    of the sums only)."""
    rng = np.random.default_rng(k)
    x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    kernel = rng.normal(0, 0.1, (k, k, 3, 64)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = from_flax({"k": kernel}, device="cpu")["k"]
    got = space_to_depth_conv(xt, kt, s, p, torch.float32)
    want = F.conv2d(xt, kt, stride=s, padding=p)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **F32_TOL)
    ref = np.asarray(ref_s2d(jnp.asarray(x), jnp.asarray(kernel), stride=s, padding=p,
                             dt=jnp.float32))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("x_shape, k_shape, s, p, match", [
    ((1, 3, 64, 64), (64, 3, 7, 5), 2, 3, "square kernels only"),
    ((1, 3, 64, 64), (64, 4, 7, 7), 2, 3, "kernel expects 4 channels"),
    ((1, 3, 65, 64), (64, 3, 7, 7), 2, 3, "divisible by stride=2"),
    ((1, 3, 64, 64), (64, 3, 5, 5), 2, 3, "need kernel 5 > 2\\*padding 6"),
], ids=["square", "channels", "divisible", "padding"])
def test_space_to_depth_conv_raises_the_references_errors(x_shape, k_shape, s, p, match):
    x, k = torch.zeros(x_shape), torch.zeros(k_shape)
    with pytest.raises(ValueError, match=match):
        space_to_depth_conv(x, k, s, p, torch.float32)
    with pytest.raises(ValueError, match=match):
        ref_s2d(jnp.zeros(np.array(x_shape)[[0, 2, 3, 1]]),
                jnp.zeros(np.array(k_shape)[[2, 3, 1, 0]]), s, p, jnp.float32)


def test_space_to_depth_stem_matches_the_reference():
    """``models.resnet.space_to_depth_stem`` (NCHW, OIHW) against the
    reference's (NHWC, HWIO) and the 7x7/2 conv, at its test's shapes (f32);
    an odd spatial dim raises as the reference's does."""
    from mpit_tpu.models.resnet import space_to_depth_stem as ref_stem
    from mpit_tpu_torch.models.resnet import space_to_depth_stem

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 20, 3)).astype(np.float32)
    kernel = rng.normal(size=(7, 7, 3, 8)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    kt = from_flax({"k": kernel}, device="cpu")["k"]
    got = space_to_depth_stem(xt, kt, torch.float32)
    assert got.shape == (2, 8, 8, 10)
    want = np.asarray(ref_stem(jnp.asarray(x), jnp.asarray(kernel), jnp.float32))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, F.conv2d(xt, kt, stride=2, padding=3),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        space_to_depth_stem(torch.zeros(1, 3, 15, 16), torch.zeros(8, 3, 7, 7),
                            torch.float32)


def test_registry_names_aliases_and_refusals():
    assert models.STEM_MODELS == ref_models.STEM_MODELS
    assert models.REMAT_MODELS == ref_models.REMAT_MODELS
    for alias, cls in [("vgg_small", "VGGSmall"), ("VGGSmall", "VGGSmall"),
                       ("resnet", "ResNet50"), ("ptb_lstm", "LSTMLM"),
                       ("lstm_lm", "LSTMLM"), ("alexnet", "AlexNet")]:
        kw = dict(vocab_size=50) if "lstm" in alias else {}
        assert type(models.get_model(alias, device="cpu", **kw)).__name__ == cls
    with pytest.raises(ValueError, match="unknown model"):
        models.get_model("nope")
    with pytest.raises(ValueError, match="unknown stem"):
        models.get_model("resnet50", stem="nope", device="cpu")
    # remat keeps the parameter tree (flax keeps it with explicit names)
    kw = dict(stage_sizes=(1, 1), in_shape=(32, 32, 3), device="cpu")
    rem = models.get_model("resnet50", remat=True, **kw)
    assert rem.remat and list(dict(rem.named_parameters())) == list(
        dict(models.get_model("resnet50", **kw).named_parameters()))
    # decode mode is ported (the serving slice): the registry builds it
    dec = models.get_model("lstm", decode=True, head=False, vocab_size=50, device="cpu")
    assert dec.decode and not dec.head


def test_tiny_lstm_easgd_round_matches_jax_trainer(topo8):
    """One f32 EASGD round (τ = 2, W = 8, SGD at the preset's lr 1.0) of
    the tiny LSTM LM: the center and the loss equal the JAX trainer's,
    the port's elastic moves through the kernel's plain version."""
    tau, b = 2, 2
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 50, (tau, 8 * b, 9)).astype(np.int32)
    x, y = tokens[..., :-1], tokens[..., 1:]
    jt = JaxEASGDTrainer(ref_models.get_model("lstm", compute_dtype=jnp.float32,
                                              **LSTM_TINY),
                         optax.sgd(1.0), topo8, tau=tau, donate_state=False)
    js = jt.init_state(jax.random.key(0), x[0, :2])
    pt = EASGDTrainer(models.get_model("lstm", compute_dtype=torch.float32,
                                       device="cpu", **LSTM_TINY),
                      SGD(1.0), Topology(8, torch.device("cpu")), tau=tau)
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.center),
                                        device="cpu"))
    js, jm = jt.step(js, x, y)
    ps, pm = pt.step(ps, x, y)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    got = to_flax(ps.center)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray,
                                                                      js.center))
    for a, g in zip(jax.tree.leaves(js.center), jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(a), rtol=1e-5, atol=1e-6)
