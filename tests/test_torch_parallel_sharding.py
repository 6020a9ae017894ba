"""The port's Megatron slices against JAX's ``NamedSharding`` shards, and the
parallel tier's refusals. In one process: no ranks are started.

JAX's ``param_shardings(..., tensor_parallel=True)`` over a (2, 4) mesh of the
conftest's 8 virtual devices places each leaf; the port's
``shard_params(tree, m, 4)`` gives rank m of the model axis its slice.

* Every leaf but the fused projections equals JAX's shard on the devices at
  model position m (OPT-1.3B-shaped and GPT-2 tiny trees, float32, the vocab
  padded by both packages' ``pad_vocab_params``).
* The fused projections (GPT-2's ``c_attn`` w and b, the xattn ``to_kv``)
  differ from JAX's plain blocks on purpose: rank m holds ``[q_m | k_m |
  v_m]`` (``[k_m | v_m]``), each part's m-th block, which is what a rank
  that computes heads m needs; JAX's GSPMD layout may hold any columns.
* int8 trees: JAX's rule replicates an int8 linear's ``w8`` and ``scale``
  (it reads their names, not their parent's); the port gives them the
  slice JAX's rule gives the float ``w`` and ``b`` of that linear, so each
  equals JAX's shard of the float layout; the int8 embedding as JAX.
* The LM's bytes on a rank equal JAX's per-device bytes and are under a
  third of the whole at a model axis of 4 (tests/test_tp_serving.py's
  shrink); ``unshard_leaf`` inverts ``shard_leaf``.
* Refusals: a mesh shape the ranks do not cover, a rendezvous that fails
  (no coordinator listening), a rendezvous without rank and world size,
  heads the model axis does not divide, a tree without an embedding, and
  a rendezvous of two ranks after ``create_mesh`` started a one-rank group.
"""
import numpy as np
import pytest

import jax
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import quant as jq
from flamingo_mini_tpu.parallel import create_mesh as jax_create_mesh
from flamingo_mini_tpu.parallel import sharding as jsharding

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.parallel import (check_tensor_parallel, create_mesh,
                                              distributed_init, pad_vocab_params,
                                              shard_params)
from flamingo_mini_tpu_torch.parallel.sharding import (FUSED, leaf_spec,
                                                       shard_leaf, unshard_leaf)
from flamingo_mini_tpu_torch.utils.params import leaves_with_path
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

from test_torch_parallel_serving import _tiny
from torch_parallel_worker import free_port

MODEL = 4


def _dotted(path):
    parts = []
    for key in path:
        parts.append(str(getattr(key, "key", getattr(key, "idx", key))))
    return ".".join(parts)


def _port_leaf(tree, dotted):
    node = tree
    for part in dotted.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def _trees(lm, int8=False):
    """(JAX tree, port tree), the vocab padded to the model axis by each
    package."""
    params = jflam.init_flamingo(jax.random.PRNGKey(0), JaxConfig(**_tiny(lm)))
    if int8:
        quant = jq.quantize_gpt2_lm if lm == "gpt2" else jq.quantize_opt_lm
        params = dict(params, lm=quant(params["lm"]),
                      xattn=jq.quantize_xattn_blocks(params["xattn"]))
    tree = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jsharding.pad_vocab_params(params, MODEL), pad_vocab_params(tree, MODEL)


def _jax_shards(x, spec, mesh):
    """{model position: JAX's shard} of ``x`` placed under ``spec``."""
    placed = jax.device_put(x, NamedSharding(mesh, spec))
    coords = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
              for d in mesh.devices.flat}
    out = {}
    for shard in placed.addressable_shards:
        out.setdefault(coords[shard.device][1], np.asarray(shard.data))
    return out


def _fused_slice(x, dim, parts, m):
    """Each packed projection's m-th block along ``dim``: rank m's heads."""
    return np.concatenate([np.array_split(c, MODEL, axis=dim)[m]
                           for c in np.split(x, parts, axis=dim)], axis=dim)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax_create_mesh((2, MODEL))


@pytest.mark.parametrize("lm", ["facebook/opt-1.3b", "gpt2"])
@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_rank_slices_are_jax_shards(mesh, lm, int8):
    jtree, ptree = _trees(lm, int8)
    specs = jsharding.param_shardings(jtree, mesh, tensor_parallel=True)
    slices = [shard_params(ptree, m, MODEL) for m in range(MODEL)]
    seen = {"fused": 0, "int8": 0, "split": 0}
    for (path, x), (_, sharding) in zip(
            jax.tree_util.tree_flatten_with_path(jtree)[0],
            jax.tree_util.tree_flatten_with_path(specs)[0]):
        dotted = _dotted(path)
        spec = sharding.spec
        parent, leaf = dotted.split(".")[-2:]
        if leaf in ("w8", "scale") and parent in jsharding._COL | jsharding._ROW:
            assert spec == P()            # JAX replicates an int8 linear's leaves
            float_path = ".".join(dotted.split(".")[:-1] + [{"w8": "w", "scale": "b"}[leaf]])
            spec = jsharding._spec_for(float_path, x.shape, "model", MODEL)
            seen["int8"] += spec != P()
        want = _jax_shards(np.asarray(x), spec, mesh)
        split = [d for d, axis in enumerate(spec) if axis is not None]
        for m in range(MODEL):
            got = _port_leaf(slices[m], dotted).numpy()
            if parent in FUSED and split:
                # head-aligned, and not JAX's block
                expect = _fused_slice(np.asarray(x), split[0], FUSED[parent], m)
                np.testing.assert_array_equal(got, expect, err_msg=dotted)
                assert got.shape == want[m].shape
                if np.ptp(np.asarray(x)):        # zero biases match either way
                    assert not np.array_equal(got, want[m]), dotted
                seen["fused"] += 1
            else:
                np.testing.assert_array_equal(got, want[m], err_msg=dotted)
        seen["split"] += bool(split)
    assert seen["split"] > 10
    if lm == "gpt2":
        assert seen["fused"] > 0
    assert (seen["int8"] > 0) == int8


@pytest.mark.parametrize("lm", ["facebook/opt-1.3b", "gpt2"])
@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_pad_vocab_params_matches_jax(lm, int8):
    jtree, ptree = _trees(lm, int8)
    jlm, plm = jtree["lm"], ptree["lm"]
    for key in plm:
        if key.startswith(("wte", "embed_tokens")):
            for (path, want), (_, got) in zip(
                    jax.tree_util.tree_flatten_with_path(jlm[key])[0],
                    jax.tree_util.tree_flatten_with_path(
                        jax.tree_util.tree_map(lambda t: t.numpy(), plm[key]))[0]):
                np.testing.assert_array_equal(got, np.asarray(want))
                assert got.shape[0] % MODEL == 0
    # divisible already: the same tree; without an embedding: refused
    again = pad_vocab_params(ptree, MODEL)
    assert all(again["lm"][k] is ptree["lm"][k] for k in ptree["lm"])
    with pytest.raises(ValueError, match="no token-embedding key"):
        pad_vocab_params({"lm": {"blocks": []}}, MODEL)


def test_rank_bytes_shrink_as_jax_shards(mesh):
    """tests/test_tp_serving.py's shrink: the OPT LM's bytes on each rank
    equal JAX's per-device bytes and are under a third of the whole."""
    jtree, ptree = _trees("facebook/opt-1.3b")
    specs = jsharding.param_shardings(jtree, mesh, tensor_parallel=True)
    total = sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(jtree["lm"]))
    jax_bytes = sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                    for x, s in zip(jax.tree_util.tree_leaves(jtree["lm"]),
                                    jax.tree_util.tree_leaves(specs["lm"])))
    for m in range(MODEL):
        lm = shard_params(ptree, m, MODEL)["lm"]
        got = sum(x.numel() * x.element_size() for _, x in leaves_with_path(lm))
        assert got == jax_bytes
    assert jax_bytes < total / 3.0, (jax_bytes, total)


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_unshard_inverts_shard(parts):
    x = torch.arange(4 * 24, dtype=torch.float32).reshape(4, 24)
    for spec in ((), (None, "model"), ("model", None)):
        slices = [shard_leaf(x, spec, m, MODEL, parts if spec == (None, "model") else 1)
                  for m in range(MODEL)]
        assert torch.equal(unshard_leaf(slices, spec, parts if spec == (None, "model")
                                        else 1), x)
    assert leaf_spec("lm.blocks.0.c_attn.w8", (8, 24), "model", MODEL) == (None, "model")
    assert leaf_spec("lm.blocks.0.c_proj.scale", (8,), "model", MODEL) == ()


def test_refusals():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r"does not cover 1 ranks"):
        create_mesh((2, 1))
    with pytest.raises(ValueError, match="num_processes and process_id"):
        distributed_init(coordinator=f"127.0.0.1:{free_port()}")
    # nobody listens at the coordinator: the rendezvous fails, loudly
    with pytest.raises(RuntimeError):
        distributed_init(coordinator=f"127.0.0.1:{free_port()}", num_processes=2,
                         process_id=1, backend="gloo", timeout=2.0)
    assert not dist.is_initialized()
    config = port.FlamingoConfig(**_tiny("gpt2"))
    with pytest.raises(ValueError, match="resampler heads"):
        check_tensor_parallel(config, 4)        # 2 resampler heads over 4 ranks
    check_tensor_parallel(config, 2)


def test_rendezvous_after_a_one_rank_mesh_raises():
    # create_mesh without a group starts a one-rank one; a later rendezvous
    # of more ranks must not return quietly on it
    assert not dist.is_initialized()
    try:
        mesh = create_mesh()
        assert mesh.size() == 1 and dist.get_world_size() == 1
        distributed_init()                      # no rendezvous asked: as it is
        distributed_init(num_processes=1, process_id=0)
        with pytest.raises(RuntimeError, match="already rank 0 of a group of 1"):
            distributed_init(coordinator=f"127.0.0.1:{free_port()}", num_processes=2,
                             process_id=0, backend="gloo", timeout=2.0)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
