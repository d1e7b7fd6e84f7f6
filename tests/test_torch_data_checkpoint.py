"""The port's data pipeline and checkpointer against the JAX package's.

- Data: the same batches bit for bit (``np.array_equal``), across
  steps, process shards and a restart from ``state_dict``.
- Checkpoints: for the same f32, bf16 and int32 trees, every member of
  the port's ``arrays.npz`` holds the reference's bytes, and the
  manifests name the same keys; each package restores the other's f32
  checkpoint, and the port restores the reference's bf16 checkpoint,
  which the reference itself cannot (a gap ROADMAP.md lists).
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.checkpoint.checkpointer import latest_step as ref_latest_step
from repro.data.pipeline import DataPipeline as RefPipeline
from repro.data.pipeline import SyntheticLM as RefSynthetic
from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step
from repro_torch.data.pipeline import DataPipeline, SyntheticLM
from repro_torch.optim import opt_state_from_reference
from repro_torch.utils.tree import tree_map, tree_paths

# -- data --------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,seed", [(256, 64, 0), (10, 17, 3), (64000, 128, 7)])
def test_samples_match_reference(vocab, seq, seed):
    port, ref = SyntheticLM(vocab, seq, seed=seed), RefSynthetic(vocab, seq, seed=seed)
    for i in (0, 1, 2, 999, 123456):
        for got, want in zip(port.sample(i), ref.sample(i)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("process_index,process_count", [(0, 1), (1, 2)])
def test_batches_match_reference(process_index, process_count):
    def batches(mod_pipe, mod_ds, start=0, n=4):
        pipe = mod_pipe(mod_ds(256, 32, seed=5), 8, process_index=process_index,
                        process_count=process_count, start_step=start)
        it = iter(pipe)
        out = [next(it) for _ in range(n)]
        pipe.stop()
        return out, pipe.state_dict()

    got, got_state = batches(DataPipeline, SyntheticLM)
    want, want_state = batches(RefPipeline, RefSynthetic)
    assert got_state == want_state
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in g:
            assert np.array_equal(g[k], w[k])


def test_pipeline_resumes_from_its_state_like_the_reference():
    pipe = DataPipeline(SyntheticLM(256, 16, seed=2), 4)
    it = iter(pipe)
    first = [next(it) for _ in range(3)]
    state = pipe.state_dict()
    pipe.stop()
    resumed = DataPipeline(SyntheticLM(256, 16, seed=2), 4)
    resumed.load_state_dict(state)
    ref = RefPipeline(RefSynthetic(256, 16, seed=2), 4)
    ref.load_state_dict(state)
    got, want = next(iter(resumed)), next(iter(ref))
    resumed.stop()
    ref.stop()
    assert np.array_equal(got["tokens"], want["tokens"])
    assert np.array_equal(got["tokens"], pipe.build_batch(3)["tokens"])
    assert not np.array_equal(got["tokens"], first[-1]["tokens"])


# -- checkpoints -------------------------------------------------------------------------


def _ref_tree(dtype: str) -> dict:
    rng = np.random.default_rng(0)
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return {
        "params": {"layers": {"w": jnp.asarray(rng.standard_normal((2, 4, 8)), dt),
                              "ln": {"scale": jnp.asarray(rng.standard_normal((2, 4)), dt)}},
                   "router": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32)},
        "opt": {"step": jnp.asarray(7, jnp.int32),
                "m": {"w": jnp.asarray(rng.standard_normal((2, 4, 8)), jnp.float32)}},
    }


def _members(directory: str, step: int) -> dict:
    with zipfile.ZipFile(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


def _manifest(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_bytes_equal_the_reference(tmp_path, dtype):
    ref_tree = _ref_tree(dtype)
    port_tree = opt_state_from_reference(jax.tree_util.tree_map(np.asarray, ref_tree), "cpu")
    meta = {"step": 3, "pipeline": {"step": 3, "seed": 0}}
    RefCheckpointer(str(tmp_path / "ref"), async_save=False).save(3, ref_tree, metadata=meta)
    ck = Checkpointer(str(tmp_path / "port"))
    ck.save(3, port_tree, metadata=meta)
    ck.wait()
    ref_m, port_m = _members(str(tmp_path / "ref"), 3), _members(str(tmp_path / "port"), 3)
    assert sorted(ref_m) == sorted(port_m)
    for name in ref_m:
        assert port_m[name] == ref_m[name], name
    got, want = _manifest(str(tmp_path / "port"), 3), _manifest(str(tmp_path / "ref"), 3)
    assert (got["step"], got["keys"], got["metadata"]) == (
        want["step"], want["keys"], want["metadata"])
    assert latest_step(str(tmp_path / "port")) == ref_latest_step(str(tmp_path / "ref")) == 3


def test_port_restores_the_reference_bf16_checkpoint_the_reference_cannot(tmp_path):
    ref_tree = _ref_tree("bfloat16")
    RefCheckpointer(str(tmp_path), async_save=False).save(5, ref_tree, metadata={"step": 5})
    with pytest.raises(ValueError):  # the reference's own restore (ROADMAP.md)
        RefCheckpointer(str(tmp_path), async_save=False).restore(
            jax.eval_shape(lambda: ref_tree))
    template = tree_map(torch.zeros_like, opt_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_tree), "cpu"))
    got, meta = Checkpointer(str(tmp_path)).restore(template)
    assert meta == {"step": 5}
    want = dict((jax.tree_util.keystr(k), v) for k, v in
                jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    for (_, leaf), w in zip(tree_paths(got), want.values()):
        assert leaf.dtype == getattr(torch, str(w.dtype))
        assert np.array_equal(leaf.float().numpy(), np.asarray(w, np.float32))


def test_reference_restores_the_port_f32_checkpoint(tmp_path):
    ref_tree = _ref_tree("float32")
    port_tree = opt_state_from_reference(jax.tree_util.tree_map(np.asarray, ref_tree), "cpu")
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(2, port_tree, metadata={"step": 2})
    got, meta = RefCheckpointer(str(tmp_path)).restore(jax.eval_shape(lambda: ref_tree))
    assert meta == {"step": 2}
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def test_save_snapshots_the_step_and_keeps_the_last_n(tmp_path):
    """The async save copies every leaf at once (the optimizer then
    writes the same tensors in place); restore is byte-exact, only
    committed steps count, and the oldest are collected."""
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(4, dtype=torch.bfloat16) / 3, "step": torch.tensor(1, dtype=torch.int32)}
    ck = Checkpointer(str(tmp_path), keep_n=2)
    for step in (1, 2, 3):
        ck.save(step, tree, metadata={"step": step})
        tree["w"].add_(1.0)  # an in-place update right after the save
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    os.makedirs(tmp_path / "step_00000009.tmp-1")  # an uncommitted staging dir
    assert latest_step(str(tmp_path)) == 3
    template = tree_map(torch.zeros_like, tree)
    got, meta = ck.restore(template, step=2)
    assert got is template and meta == {"step": 2}
    assert torch.equal(got["w"], torch.arange(12, dtype=torch.float32).reshape(3, 4) + 1)
    assert torch.equal(got["b"].view(torch.int16), tree["b"].view(torch.int16))
    with pytest.raises(ValueError):
        ck.restore({"w": torch.zeros(4, 3), "b": got["b"], "step": got["step"]})
    with pytest.raises(KeyError):
        ck.restore({"missing": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(template)
