"""K8 field_block_scatter and the --field_blocks path of the port against
the JAX package's, on the CPU.

The plain K8 is held to pallas_embedding.field_block_scatter (interpret
mode) at the patterns of tests/test_pallas_embedding.py and at the cases
that make it differ from a plain scatter-add (ids outside their field's
block, -1 padding, overlapping blocks), in f32 and in bf16 mode, within
1e-5: f32 sums in another order (the TPU kernel sums per 512-row vocab
chunk and batch tile on the MXU); in bf16 mode both round each gradient
element to bf16 before the f32 sum.

The 5-step dense DeepFM --field_blocks trajectory (f32 towers; the JAX
lookup in interpret mode, its CPU default) is held to 2e-5 relative on
the loss, the bar of the dense trajectory in
tests/test_torch_sparse_step.py. The weights: 1e-5 in f32 mode, as there;
1e-4 in bf16 mode, the lookups as the two harnesses build them. Both sides
round their f32 table gradients to bf16, and those gradients differ in
f32 summation order, so an element within an f32 ulp of a bf16 rounding
boundary rounds the other way on one side: 2^-8 of that gradient element,
which Adam at lr 1e-2 turns into up to ~4e-5 in the weight (measured
3.3e-5 on 9 of 2,000 elements)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.features.criteo import field_blocks_from_feature_map as jax_field_blocks
from tf_repos_tpu.ops import pallas_embedding as PE
from tf_repos_tpu.train.harness import Harness as JaxHarness
from tf_repos_tpu.train.loop import build_train_step as jax_build_train_step
from tf_repos_tpu.train.optimizers import make_optimizer as jax_make_optimizer
from tf_repos_tpu_torch import main as CLI
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.synthetic import synthetic_criteo_batch, write_synthetic_libsvm
from tf_repos_tpu_torch.features.criteo import field_blocks_from_feature_map
from tf_repos_tpu_torch.ops import field_block as FB
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.train.loop import build_train_step
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves


def _field_blocks(num_fields, sizes_pattern, start=0):
    sizes = [sizes_pattern[i % len(sizes_pattern)] for i in range(num_fields)]
    offsets, off = [], start
    for s in sizes:
        offsets.append(off)
        off += s
    return tuple(offsets), tuple(sizes), off


def _in_block_ids(rng, offsets, sizes, b):
    return np.stack([rng.integers(o, o + s, size=b) for o, s in zip(offsets, sizes)],
                    axis=1).astype(np.int32)


def _jax_scatter(ids, g, vocab, offsets, sizes, use_bf16, tile_b=16, tile_v=32):
    return np.asarray(PE.field_block_scatter(
        jnp.asarray(ids), jnp.asarray(g), vocab, offsets, sizes,
        tile_b=tile_b, tile_v=tile_v, use_bf16=use_bf16, interpret=True))


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("sizes_pattern", [(64,), (8, 200, 64)])
def test_plain_matches_pallas(sizes_pattern, use_bf16):
    rng = np.random.default_rng(0)
    offsets, sizes, vocab = _field_blocks(5, sizes_pattern)
    ids = _in_block_ids(rng, offsets, sizes, 48)
    g = rng.normal(size=(48, 5, 9)).astype(np.float32)
    got = FB.field_block_scatter(torch.from_numpy(ids), torch.from_numpy(g), vocab, offsets,
                                 sizes, use_bf16=use_bf16)
    want = _jax_scatter(ids, g, vocab, offsets, sizes, use_bf16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _masked_case(kind, rng):
    """ids that a plain scatter-add would get wrong: drawn over the whole
    vocab (most outside their field's block), -1 padding rows, or
    fields whose blocks overlap."""
    if kind == "overlap":
        offsets, sizes, vocab = (0, 20, 30, 30, 5), (40, 30, 10, 25, 1), 64
        ids = _in_block_ids(rng, offsets, sizes, 37)
    else:
        offsets, sizes, vocab = _field_blocks(4, (1, 30, 12), start=3)
        ids = (rng.integers(0, vocab, size=(37, 4)) if kind == "out_of_block"
               else _in_block_ids(rng, offsets, sizes, 37)).astype(np.int32)
        if kind == "padding":
            ids[-9:] = -1
            ids[:5, 2] = -1
    g = rng.normal(size=(37, len(offsets), 6)).astype(np.float32)
    return ids, g, vocab, offsets, sizes


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["out_of_block", "padding", "overlap"])
def test_field_mask_matches_pallas(kind, use_bf16):
    rng = np.random.default_rng(1)
    ids, g, vocab, offsets, sizes = _masked_case(kind, rng)
    got = FB.field_block_scatter(torch.from_numpy(ids), torch.from_numpy(g), vocab, offsets,
                                 sizes, use_bf16=use_bf16).numpy()
    want = _jax_scatter(ids, g, vocab, offsets, sizes, use_bf16, tile_b=16, tile_v=16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kind != "overlap":  # not a plain scatter-add
        plain = np.asarray(PE.scatter_reference(jnp.asarray(ids), jnp.asarray(g), vocab))
        assert np.abs(plain - want).max() > 1e-3


def test_field_plan_takes_hot_fields_into_shared_memory():
    # the DeepFM point: 13 one-row blocks, 26 blocks of 4,521 rows, W = 17
    offsets = tuple(range(1, 14)) + tuple(14 + j * 4521 for j in range(26))
    sizes = (1,) * 13 + (4521,) * 26
    table, n_acc = FB.field_plan(offsets, sizes, 17)
    assert table[:78] == [*offsets, *sizes]
    assert table[78:91] == [17 * i for i in range(13)] and table[91:] == [-1] * 26
    assert n_acc == 13 * 17
    # five fields of 64 rows: 2048 / 5 pairs a tile hit each row ~6.4 times
    _, n_acc = FB.field_plan((0, 64, 128, 192, 256), (64,) * 5, 9)
    assert n_acc == 5 * 64 * 9


@pytest.mark.parametrize("use_bf16", [False, True], ids=["f32", "bf16"])
def test_lookup_grads_match_jax(use_bf16):
    rng = np.random.default_rng(2)
    offsets, sizes, vocab = _field_blocks(4, (32, 96))
    ids = _in_block_ids(rng, offsets, sizes, 24)
    ids[-3:, 1] = -1  # padding: gathers the last row, gets no gradient
    table = rng.normal(size=(vocab, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    jlk = PE.make_field_block_lookup(vocab, offsets, sizes, tile_b=16, tile_v=32, use_bf16=use_bf16)
    g_jax = jax.grad(lambda t: jnp.sum(jnp.einsum("bfk,fk->b", jlk(t, jnp.asarray(ids)),
                                                  jnp.asarray(w)) ** 2))(jnp.asarray(table))
    tlk = FB.make_field_block_lookup(vocab, offsets, sizes, use_bf16=use_bf16)
    assert not hasattr(tlk, "static_slice_ok")
    t = torch.from_numpy(table).requires_grad_(True)
    out = tlk(t, torch.from_numpy(ids))
    (g_t,) = torch.autograd.grad(torch.sum(torch.einsum("bfk,fk->b", out, torch.from_numpy(w)) ** 2), t)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_jax), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jlk(jnp.asarray(table), jnp.asarray(ids))))


def test_lookup_non_bf_ids_take_the_plain_reference():
    rng = np.random.default_rng(5)
    vocab, k = 50, 3
    ids = rng.integers(-1, vocab, size=(6, 4, 5)).astype(np.int32)
    table = rng.normal(size=(vocab, k)).astype(np.float32)
    ct = rng.normal(size=(6, 4, 5, k)).astype(np.float32)
    tlk = FB.make_field_block_lookup(vocab, (0,), (vocab,))
    t = torch.from_numpy(table).requires_grad_(True)
    (g_t,) = torch.autograd.grad((tlk(t, torch.from_numpy(ids)) * torch.from_numpy(ct)).sum(), t)
    want = PE.scatter_reference(jnp.asarray(ids).reshape(-1, 5), jnp.asarray(ct), vocab)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_field_blocks_from_feature_map_matches_jax(tmp_path):
    fm = tmp_path / "feature_map"
    lines = [f"I{i} {i}" for i in range(1, 14)]
    lines += ["C1|<unk> 13", "C1|a 14", "C1|b 15", "C2|<unk> 16", "C2|x 17", "C10|y 30", "C10|z 25"]
    fm.write_text("\n".join(lines) + "\n")
    got = field_blocks_from_feature_map(str(fm))
    assert got == jax_field_blocks(str(fm))
    assert got[0][13:] == (13, 16, 25) and got[1][13:] == (3, 2, 6)


# ------------------------------------------------------------------ dense step
V = 400
# the synthetic writer's zipf_a=0 layout: continuous ids 1..13, then 26
# equal blocks (data/synthetic.py)
BLOCK = (V - 14) // 26
OFFSETS = tuple(range(1, 14)) + tuple(14 + j * BLOCK for j in range(26))
SIZES = (1,) * 13 + (BLOCK,) * 26
FIELD_BLOCKS = ",".join(f"{o}:{s}" for o, s in zip(OFFSETS, SIZES))
KW = dict(model="DeepFM", feature_size=V, field_size=39, embedding_size=4, deep_layers="16,8",
          dropout="1.0,1.0", batch_size=32, l2_reg=1e-4, learning_rate=1e-2,
          field_blocks=FIELD_BLOCKS)


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16_harness", "f32"])
def test_dense_field_blocks_trajectory_matches_jax_harness_step(use_bf16):
    jh = JaxHarness(JaxConfig(**KW, mesh_data=1, mesh_model=1))
    th = Harness(Config(**KW, device="cpu"))
    if use_bf16:  # the lookups as each harness builds them
        jlk, tlk = jh._field_block_lookup(), th.field_block_lookup()
    else:
        jlk = PE.make_field_block_lookup(V, OFFSETS, SIZES, use_bf16=False)
        tlk = FB.make_field_block_lookup(V, OFFSETS, SIZES, use_bf16=False)
    jm, tm = jh.model, th.model
    jp, js = jm.init(jax.random.PRNGKey(0))
    tp, ts = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    jtx, ttx = jax_make_optimizer("Adam", 1e-2), make_optimizer("Adam", 1e-2)
    jo, to = jtx.init(jp), ttx.init(tp)
    jstep, tstep = jax_build_train_step(jm, jtx, lookup=jlk), build_train_step(tm, ttx, lookup=tlk)
    rng = np.random.default_rng(7)
    key = jax.random.PRNGKey(1)
    FB.reset_launches()
    for i in range(5):
        b = synthetic_criteo_batch(rng, 32, V)
        jp, jo, js, lj = jstep(jp, jo, js, {k: jnp.asarray(v) for k, v in b.items()}, key)
        tp, to, ts, lt = tstep(tp, to, ts, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5, err_msg=f"step {i}")
    assert FB.field_block_scatter.launches == 0  # CPU tensors: the plain version
    tol = 1e-4 if use_bf16 else 1e-5
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)


def test_field_blocks_ignored_by_the_sparse_step():
    h = Harness(Config(**KW, device="cpu", sparse_table_update=True))
    assert h.field_block_lookup() is None


@pytest.mark.parametrize("form", ["pairs", "auto"])
def test_cli_train_then_eval_with_field_blocks(tmp_path, form):
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_libsvm(str(d / "tr.libsvm"), 160, feature_size=V, seed=0)
    write_synthetic_libsvm(str(d / "va.libsvm"), 64, feature_size=V, seed=1)
    if form == "auto":
        fm = tmp_path / "feature_map"
        lines = [f"I{i} {i}" for i in range(1, 14)]
        lines += [f"C{j + 1}|v{e} {o + e}" for j, o in enumerate(OFFSETS[13:]) for e in (0, BLOCK - 1)]
        fm.write_text("\n".join(lines) + "\n")
        blocks = f"auto:{fm}"
        assert field_blocks_from_feature_map(str(fm)) == (OFFSETS, SIZES)
    else:
        blocks = FIELD_BLOCKS
    common = ["--model=DeepFM", f"--feature_size={V}", "--field_size=39", "--embedding_size=4",
              "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=32", "--num_epochs=1",
              "--log_steps=2", "--eval_throttle_secs=0", f"--data_dir={d}",
              f"--model_dir={tmp_path}/m/", "--dt_dir=x", "--device=cpu",
              "--compute_dtype=bfloat16", f"--field_blocks={blocks}"]
    res = CLI.main(["--task_type=train", *common])
    assert res["step"] == 5 and np.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0
    ev = CLI.main(["--task_type=eval", *common])
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
