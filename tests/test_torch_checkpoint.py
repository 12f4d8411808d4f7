"""Checkpoints, the token stream and the training launcher of the port,
on the CPU, against the JAX package.

A checkpoint written by either package loads in the other with every
array bitwise equal (f32, bf16 through its ``uint16`` bits, int32,
bool, None, nested dicts and a list; the reference loads into JAX
arrays, which hold no int64, so a step count's int64 is held in the
file), and ``restore_like`` returns a template's structure, dtypes and
values bitwise.  ``data.token_lm_batches`` fed the reference's Gumbel draws
gives its tokens exactly (the argmax of the same f32 sums).  The
launcher trains a few steps with ``--device cpu`` and its checkpoint
restores the trained parameters bitwise.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro import data as JD
from repro_torch import checkpoint, data, optim
from repro_torch.launch import train as LT


def _numpy_tree(seed=0):
    rs = np.random.RandomState(seed)
    return {"params": {"w": rs.randn(3, 4).astype(np.float32),
                       "blocks": {"ln": rs.randn(2, 5).astype(np.float32),
                                  "h": rs.randn(2, 3, 2).astype(
                                      ml_dtypes.bfloat16)}},
            "ids": rs.randint(-9, 9, (4,)).astype(np.int32),
            "mask": rs.rand(5) < 0.5,
            "opt": {"mu": None, "seq": [rs.randn(2).astype(np.float32),
                                        rs.randn(1).astype(np.float32)]}}


def _torch_tree(tree):
    """The numpy tree as the port holds it: bf16 leaves as torch bf16."""
    def conv(a):
        if a is None:
            return None
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return conv(tree)


def _bits(a):
    """A leaf's raw bytes and dtype name, whatever the package."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().tobytes(), "bfloat16"
        a = a.numpy()
    a = np.asarray(a)
    return a.tobytes(), str(a.dtype)


def _npz(path):
    with np.load(path) as z:
        return {k: (z[k].dtype, z[k].tobytes()) for k in z.files}


def test_port_and_reference_write_the_same_file(tmp_path):
    tree = _numpy_tree()
    JC.save(str(tmp_path / "j.npz"), tree)
    checkpoint.save(str(tmp_path / "t.npz"), dict(_torch_tree(tree), step=7))
    JC.save(str(tmp_path / "j7.npz"), dict(tree, step=7))
    assert _npz(tmp_path / "t.npz") == _npz(tmp_path / "j7.npz")


def test_each_package_loads_the_others_file_bitwise(tmp_path):
    tree = _numpy_tree(1)
    JC.save(str(tmp_path / "j.npz"), tree)
    checkpoint.save(str(tmp_path / "t.npz"), _torch_tree(tree))
    from_jax = checkpoint.load(str(tmp_path / "j.npz"))
    from_port = JC.load(str(tmp_path / "t.npz"))
    want = checkpoint._flatten(tree)
    for loaded in (from_jax, from_port):
        got = checkpoint._flatten(loaded)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k.endswith("#none"):
                continue
            assert _bits(got[k]) == _bits(v), k
    assert from_jax["opt"]["mu"] is None
    assert from_jax["params"]["blocks"]["h"].dtype == torch.bfloat16


def test_restore_like_gives_back_the_template_bitwise(tmp_path):
    tree = _torch_tree(_numpy_tree(2))
    tree["step"] = 11
    checkpoint.save(str(tmp_path / "c.npz"), tree)
    template = optim.tree_map(
        lambda t: None if t is None else torch.zeros_like(t),
        {k: v for k, v in tree.items() if k not in ("opt", "step")})
    template["step"] = 0
    back = checkpoint.restore_like(template, checkpoint.load(
        str(tmp_path / "c.npz")))
    assert back["step"] == 11
    for k in ("params", "ids", "mask"):
        for a, b in zip(optim.tree_leaves(back[k]),
                        optim.tree_leaves(tree[k])):
            assert a.dtype == b.dtype and _bits(a) == _bits(b)


@pytest.mark.parametrize("V,B,S,n", [(64, 2, 7, 3), (512, 3, 16, 2)])
def test_token_stream_from_the_reference_draws_is_its_stream(V, B, S, n):
    key = jax.random.PRNGKey(V + S)
    want = JD.token_lm_batches(key, V, B, S, n)
    draws = [np.asarray(jax.random.gumbel(k, (B, S + 1, V), jnp.float32))
             for k in jax.random.split(key, n)]
    got = data.token_lm_batches(V, B, S, n, gumbel=draws, device="cpu")
    assert len(got) == n
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int32 and g[k].shape == (B, S)
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_token_stream_from_a_generator_is_seeded_and_zipf_like():
    a = data.token_lm_batches(64, 4, 256, 2, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    b = data.token_lm_batches(64, 4, 256, 2, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    for x, y in zip(a, b):
        assert torch.equal(x["tokens"], y["tokens"])
        assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    counts = torch.bincount(a[0]["tokens"].flatten().long(), minlength=64)
    assert counts[0] > counts[8] > counts[63]


def test_launcher_trains_on_the_cpu_and_its_checkpoint_restores(tmp_path):
    path = tmp_path / "run.npz"
    loss, params = LT.run(["--device", "cpu", "--layers", "1",
                           "--d-model", "64", "--steps", "3", "--batch", "2",
                           "--seq", "16", "--log-every", "1", "--ckpt",
                           str(path)])
    assert np.isfinite(loss)
    back = checkpoint.restore_like({"params": params, "step": 0},
                                   checkpoint.load(str(path)))
    assert back["step"] == 3
    for a, b in zip(optim.tree_leaves(back["params"]),
                    optim.tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert LT.main(["--device", "cpu", "--layers", "1", "--d-model", "64",
                    "--steps", "2", "--batch", "2", "--seq", "8"]) > 0
