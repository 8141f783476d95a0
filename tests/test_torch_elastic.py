"""The port's elastic update and EASGD round against the JAX package.

Inputs come from numpy with a seed and go through both packages on the
CPU. The port side runs with CPU tensors, so it takes its plain PyTorch
version; the JAX side runs its Pallas kernel in interpret mode, as
``tests/test_ops.py`` does. Tolerance 1e-6, the reference's own: a compiler
may contract ``x - α(x - c)`` into a fused multiply-add and move the last
bit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mpit_tpu import goptim as jax_goptim
from mpit_tpu.ops import elastic_update as jax_elastic_update
from mpit_tpu.ops.elastic import BLOCK_ROWS, LANE
from mpit_tpu_torch import goptim
from mpit_tpu_torch.models import LeNet
from mpit_tpu_torch.ops import _build
from mpit_tpu_torch.ops import elastic as port_elastic
from mpit_tpu_torch.utils.params import tree_leaves

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [
    (7,),                       # far below one TPU block, ragged
    (BLOCK_ROWS * LANE,),       # exactly one TPU block
    (BLOCK_ROWS * LANE + 13,),  # one block + ragged tail
    (3, 50, 11),                # multi-rank
]


def _inputs(shape, seed, w=None):
    rng = np.random.default_rng(seed)
    xs = shape if w is None else (w, *shape)
    return (
        rng.normal(size=xs).astype(np.float32),
        rng.normal(size=shape).astype(np.float32),
        rng.normal(size=shape).astype(np.float32),
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_elastic_matches_jax_pallas_interpret(shape):
    x, c, d = _inputs(shape, 0)
    alpha = 0.3
    ref_x, ref_c = jax_elastic_update(x, c, d, alpha, use_pallas=True)
    out_x, out_c = port_elastic.elastic_update(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(d), alpha
    )
    assert tuple(out_x.shape) == shape and tuple(out_c.shape) == shape
    np.testing.assert_allclose(out_x.numpy(), np.asarray(ref_x), **TOL)
    np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_c), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_elastic_stacked_matches_per_worker_reference(shape):
    """The stacked (W, ...) form against W separate reference calls: every
    worker's row moves on its own, the center moves once."""
    w, alpha = 8, 0.9 / 8
    x, c, d = _inputs(shape, 1, w=w)
    out_x, out_c = port_elastic.elastic_update(
        torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(d), alpha
    )
    assert tuple(out_x.shape) == (w, *shape)
    for i in range(w):
        ref_x, ref_c = jax_elastic_update(x[i], c, d, alpha, use_pallas=False)
        np.testing.assert_allclose(out_x[i].numpy(), np.asarray(ref_x), **TOL)
        np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_c), **TOL)


def test_elastic_cpu_path_counts_no_launch():
    before = port_elastic.launches
    x, c, d = (torch.from_numpy(a) for a in _inputs((5,), 2))
    port_elastic.elastic_update(x, c, d, 0.1)
    port_elastic.elastic_update(x, c, d, 0.1, use_kernel=False)
    assert port_elastic.launches == before


# the leaves of one round: LeNet's, and ragged ones (n % 4 != 0)
LEAF_SHAPES = {
    "lenet": [tuple(t.shape) for t in tree_leaves(
        LeNet(device="cpu").init(torch.Generator().manual_seed(0)))],
    "ragged": [(7,), (13,), (3, 50, 11), (BLOCK_ROWS * LANE + 13,), (1,)],
}


def _leaves(kind, w, seed):
    """numpy (x, c, d) per leaf, and the same as torch lists."""
    arrs = [_inputs(s, seed + i, w=None if w == 1 else w)
            for i, s in enumerate(LEAF_SHAPES[kind])]
    return arrs, [[torch.from_numpy(a[j]) for a in arrs] for j in range(3)]


@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("kind", ["lenet", "ragged"])
def test_elastic_leaves_match_jax_pallas_interpret(kind, w):
    """The whole-tree update against the reference's kernel, leaf by leaf
    and worker by worker; on CPU tensors it counts no launch."""
    alpha = 0.9 / 8
    arrs, (xs, cs, ds) = _leaves(kind, w, 20)
    before = port_elastic.launches
    new_xs, new_cs = port_elastic.elastic_update_leaves(xs, cs, ds, alpha)
    assert port_elastic.launches == before
    assert len(new_xs) == len(new_cs) == len(arrs)
    for (x, c, d), nx, nc in zip(arrs, new_xs, new_cs):
        assert nx.shape == x.shape and nc.shape == c.shape
        for row, got in ([(x, nx)] if w == 1 else zip(x, nx)):
            ref_x, ref_c = jax_elastic_update(row, c, d, alpha, use_pallas=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_x), **TOL)
            np.testing.assert_allclose(nc.numpy(), np.asarray(ref_c), **TOL)


def test_elastic_leaves_plain_is_the_per_leaf_update():
    _, (xs, cs, ds) = _leaves("ragged", 8, 30)
    before = port_elastic.launches
    for use_kernel in (None, False):
        new_xs, new_cs = port_elastic.elastic_update_leaves(xs, cs, ds, 0.1, use_kernel)
        for x, c, d, nx, nc in zip(xs, cs, ds, new_xs, new_cs):
            want_x, want_c = port_elastic.elastic_update(x, c, d, 0.1)
            assert torch.equal(nx, want_x) and torch.equal(nc, want_c)
    assert port_elastic.launches == before
    assert port_elastic.elastic_update_leaves([], [], [], 0.1) == ([], [])


@pytest.mark.parametrize("bad,match", [
    ("cpu-tensor", "not CUDA"),
    ("mixed-w", "not one W"),
    ("lists", "leaves"),
])
def test_elastic_leaves_kernel_refuses_before_any_launch(bad, match):
    """use_kernel=True refuses a CPU tensor, leaves that stack different
    W, and lists of different lengths, all before a launch."""
    _, (xs, cs, ds) = _leaves("ragged", 8, 40)
    if bad == "mixed-w":
        xs[1] = xs[1][:3].contiguous()
    elif bad == "lists":
        ds = ds[:-1]
    before = port_elastic.launches
    with pytest.raises(ValueError, match=f"elastic kernel: .*{match}"):
        port_elastic.elastic_update_leaves(xs, cs, ds, 0.1, use_kernel=True)
    assert port_elastic.launches == before


def test_every_elastic_ctypes_entry_matches_a_c_entry():
    """Each ``_ARGTYPES`` entry is an ``extern "C"`` function of
    ``elastic.cu`` with as many parameters as its ctypes declaration, and
    the wrapper's cap on leaves per launch is the kernel's table size.
    Reads the source only: no nvcc."""
    src = (_build.CSRC / "elastic.cu").read_text()
    entries = {name: len(params.split(","))
               for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert entries == {k: len(v) for k, v in port_elastic._ARGTYPES.items()}
    cap = re.search(r"constexpr int kMaxLeaves = (\d+);", src)
    assert cap and int(cap.group(1)) == port_elastic.MAX_LEAVES


def _jax_round(topo, params, center, use_pallas, compress_dtype=None):
    def f(p, c):
        p0 = jax.tree.map(lambda a: a[0], p)
        np_, nc = jax_goptim.easgd_round(
            p0, c, 0.1, topo.worker_axis, use_pallas=use_pallas,
            compress_dtype=compress_dtype,
        )
        return jax.tree.map(lambda a: a[None], np_), nc

    fn = jax.jit(jax.shard_map(
        f, mesh=topo.mesh,
        in_specs=(P(topo.worker_axis), P()),
        out_specs=(P(topo.worker_axis), P()),
        check_vma=False,
    ))
    return fn(params, center)


def _dict_tree(w, rng):
    params = {"a": rng.normal(size=(w, 40)).astype(np.float32),
              "b": rng.normal(size=(w, 3, 5)).astype(np.float32)}
    center = {"a": rng.normal(size=(40,)).astype(np.float32),
              "b": rng.normal(size=(3, 5)).astype(np.float32)}
    return params, center


def _tuple_tree(w, rng):
    params = (rng.normal(size=(w, 4)).astype(np.float32),
              rng.normal(size=(w, 3)).astype(np.float32))
    center = (rng.normal(size=(4,)).astype(np.float32),
              rng.normal(size=(3,)).astype(np.float32))
    return params, center


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


@pytest.mark.parametrize("make_tree", [_dict_tree, _tuple_tree],
                         ids=["dict", "tuple-containers"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("use_kernel", [False, None], ids=["tree-moves", "per-leaf"])
def test_easgd_round_matches_jax(topo8, make_tree, use_pallas, use_kernel):
    """Port easgd_round (stacked, one device) against goptim.easgd_round
    under shard_map on the 8-device CPU mesh, with the reference's kernel
    on and off and both of the port's paths; tuple containers round-trip."""
    w = topo8.num_workers
    params, center = make_tree(w, np.random.default_rng(1))
    ref_p, ref_c = _jax_round(topo8, params, center, use_pallas)
    out_p, out_c = goptim.easgd_round(
        _to_torch(params), _to_torch(center), 0.1, use_kernel=use_kernel
    )
    assert type(out_p) is type(params) and type(out_c) is type(center)
    for a, b in zip(jax.tree.leaves((ref_p, ref_c)),
                    jax.tree.leaves((out_p, out_c))):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("use_kernel", [False, None], ids=["tree-moves", "per-leaf"])
def test_easgd_round_bf16_exchange_matches_jax(topo8, use_kernel):
    """compress_dtype=bf16: the clients' move is exact; the center's move
    carries the bf16 rounding of the diff sum. The reference sums eight
    bf16 values in bf16 across devices, the port accumulates in float32
    and rounds once, so the two sums may differ by a few bf16 ulps of the
    sum's magnitude (2^-8 relative each); with α = 0.1 that is at most
    ~0.1 * 4 * 2^-8 * |Σ d| on the center."""
    w = topo8.num_workers
    params, center = _dict_tree(w, np.random.default_rng(4))
    ref_p, ref_c = _jax_round(topo8, params, center, False, jnp.bfloat16)
    out_p, out_c = goptim.easgd_round(
        _to_torch(params), _to_torch(center), 0.1, use_kernel=use_kernel,
        compress_dtype=torch.bfloat16,
    )
    for a, b in zip(jax.tree.leaves(ref_p), jax.tree.leaves(out_p)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    for k in center:
        sums = np.abs((params[k] - center[k]).sum(0))
        bound = 0.1 * 4 * 2.0**-8 * sums + 1e-6
        err = np.abs(out_c[k].numpy() - np.asarray(ref_c[k]))
        assert (err <= bound).all(), float((err - bound).max())
    # and the compression does something: the exact center differs
    exact_p, exact_c = goptim.easgd_round(
        _to_torch(params), _to_torch(center), 0.1, use_kernel=False
    )
    assert not torch.equal(exact_c["a"], out_c["a"])


def test_downpour_push_pull():
    rng = np.random.default_rng(5)
    center = {"a": torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))}
    upd = {"a": torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))}
    avg = goptim.downpour_push(center, upd)
    tot = goptim.downpour_push(center, upd, average=False)
    torch.testing.assert_close(avg["a"], center["a"] + upd["a"].mean(0))
    torch.testing.assert_close(tot["a"], center["a"] + upd["a"].sum(0))
    assert goptim.downpour_pull(center) is center
    assert goptim.downpour_pull(center, stale_center=avg) is avg
