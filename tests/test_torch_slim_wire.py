"""--slim_transfer in the port (tf_repos_tpu_torch/data/slim_wire.py and
its harness wiring) against the JAX package's data/slim_wire.py, on the
CPU.

- The encoders, fed the same host batches, give the same keys, dtypes,
  shapes and bytes as JAX's: the Criteo wire after the dedup mapper; the
  Ali-CCP wire padded (narrowed and not), after the mapper and the COO
  packer (the counts form), under --mh_coo_combine (w kept), both lo/hi
  idx forms (bound <= 2^17: the 17th bit packed; <= 2^24: a u8 high
  byte), real-valued vals kept, and one SharedWireState across two
  encoders.
- Contract violations raise ValueError with JAX's text.
- The decode round trip is exact, and equal to JAX's decode.
- Harness runs: the training split's decoded slim batches equal the
  batches without --slim_transfer; a --slim_transfer CLI run's per-step
  losses equal the same run's without it exactly, and match the JAX
  package's --slim_transfer run within 2e-5 relative (its bar between two
  formulations of one step), for DeepFM (lazy, --pallas_expand's plain
  versions), ESMM (--mh_coo, the encoder on the --map_workers pool) and
  DIN (--mh_coo attention, the compact stream rebuilt from the wire's
  counts); export writes the wrapped model; the harness's refusals.
- The presets: each of the four single-process --preset names trains 2
  steps, evaluates and exports through tf_repos_tpu_torch.main with
  --device=cpu, small widths passed as overrides."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_repos_tpu import main as JAX_CLI
from tf_repos_tpu.config import Config as JaxConfig
from tf_repos_tpu.data import slim_wire as JW
from tf_repos_tpu.models import create_model as jax_create_model
from tf_repos_tpu_torch import main as CLI
from tf_repos_tpu_torch.config import Config, parse_config
from tf_repos_tpu_torch.data import slim_wire as W
from tf_repos_tpu_torch.data.sparse_batch import (
    MHC_CDEST,
    MHC_CNT,
    MHC_DEST,
    MHC_IDX,
    MHC_W,
    MhCooPacker,
    SparseBatchMapper,
)
from tf_repos_tpu_torch.data.synthetic import (
    PUBLISHED_MH_AVG_LENS,
    synthetic_aliccp_batch,
    synthetic_criteo_batch,
    write_synthetic_aliccp,
    write_synthetic_libsvm,
)
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.serve.scorer import Scorer
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
from tf_repos_tpu_torch.train.harness import Harness
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.tree import tree_leaves

ESMM = dict(model="ESMM", feature_size=400, field_size=11, embedding_size=4,
            deep_layers="8,4", dropout="1.0,1.0", batch_size=8, multi_hot_pad=4)


def _ali(seed=0, b=8, v=400, pad=4):
    return synthetic_aliccp_batch(np.random.default_rng(seed), b, v, multi_hot_pad=pad)


def _same_wire(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def _decode(wire, fn):
    return {k: v.numpy() for k, v in fn({k: torch.from_numpy(np.array(v)) for k, v in wire.items()}).items()}


def _jax_decode(wire, fn):
    return {k: np.asarray(v) for k, v in fn({k: jnp.asarray(v) for k, v in wire.items()}).items()}


def _exact(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def _coo_stream(model, combine=False, seeds=range(3), pad=4):
    mapper = SparseBatchMapper(model.sparse_slots())
    packer = MhCooPacker(model.mh_coo_groups(), floor=8, combine=combine, cdest_aux=True)
    return [mapper(packer(_ali(s, pad=pad))) for s in seeds]


def _lohi(bound, seed=0):
    """A hand-built mapped COO batch whose uids bucket (the array's size)
    sets the id bound; one live slot has low 16 bits of zero."""
    rng = np.random.default_rng(seed)
    ngr, bs, m = 3, 4, 64
    counts = rng.integers(0, 5, size=(1, ngr, bs))
    dv = (np.arange(bs)[None, :] * ngr + np.arange(ngr)[:, None]).reshape(-1)
    live = int(counts[0].sum())
    dest = np.zeros((1, m), np.int32)
    dest[0, :live] = np.repeat(dv, counts[0].reshape(-1))
    idx = np.zeros((1, m), np.int32)
    vals = rng.integers(1, bound, size=live)
    vals[0] = 1 << 16
    idx[0, :live] = vals
    return {"y": np.zeros(bs, np.float32), "z": np.zeros(bs, np.float32),
            "mask": np.ones(bs, np.float32), "__uids_emb": np.zeros(bound, np.int32),
            MHC_IDX: idx, MHC_DEST: dest, MHC_W: (idx > 0).astype(np.float32),
            MHC_CNT: counts.astype(np.int32)}


def _case(name):
    """(stream of host batches, port encoder, JAX encoder, port decode, JAX decode)."""
    if name == "criteo_after_mapper":
        cfg = Config(model="DeepFM", feature_size=400, field_size=39, static_fields=13)
        mapper = SparseBatchMapper(create_model(cfg).sparse_slots())
        stream = []
        for s in range(3):
            b = synthetic_criteo_batch(np.random.default_rng(s), 16, 400, zipf_a=1.2)
            b["mask"][-3:] = 0.0
            for k in ("feat_ids", "feat_vals"):
                b[k][-3:] = 0
            stream.append(mapper(b))
        return (stream, lambda b: W.encode_batch(b, 13), lambda b: JW.encode_batch(b, 13),
                lambda b: W.decode_batch(b, 13), lambda b: JW.decode_batch(b, 13))
    model = create_model(Config(**ESMM))
    ngr = len(model.mh_coo_groups())
    if name == "aliccp_padded":
        stream, enc, jenc = [_ali(s) for s in range(3)], W.AliccpSlimEncoder(400), JW.AliccpSlimEncoder(400)
    elif name == "aliccp_padded_wide_vocab":
        stream = [_ali(s, v=200_000) for s in range(2)]
        enc, jenc = W.AliccpSlimEncoder(200_000), JW.AliccpSlimEncoder(200_000)
    elif name == "aliccp_real_vals":
        stream = [_ali(s) for s in range(2)]
        for b in stream:
            b["u_catvals"] = b["u_catvals"] * np.float32(2.5)
        enc, jenc = W.AliccpSlimEncoder(400), JW.AliccpSlimEncoder(400)
    elif name == "aliccp_mh_coo_counts":
        stream = _coo_stream(model)
        enc, jenc = W.AliccpSlimEncoder(400, n_groups=ngr), JW.AliccpSlimEncoder(400, n_groups=ngr)
    elif name == "aliccp_mh_coo_combine":
        stream = _coo_stream(model, combine=True, pad=12)
        enc = W.AliccpSlimEncoder(400, n_groups=ngr, drop_w_ok=False)
        jenc = JW.AliccpSlimEncoder(400, n_groups=ngr, drop_w_ok=False)
    elif name in ("lohi_bits", "lohi_u8"):
        bound = (1 << 17) if name == "lohi_bits" else (1 << 20)
        stream = [_lohi(bound, s) for s in range(2)]
        enc, jenc = W.AliccpSlimEncoder(bound, n_groups=3), JW.AliccpSlimEncoder(bound, n_groups=3)
    elif name == "shared_state":
        stream = _coo_stream(model, seeds=range(4))
        shared, jshared = W.SharedWireState(), JW.SharedWireState()
        encs = [W.AliccpSlimEncoder(400, n_groups=ngr, shared=shared) for _ in range(2)]
        jencs = [JW.AliccpSlimEncoder(400, n_groups=ngr, shared=jshared) for _ in range(2)]
        turn = {"p": 0, "j": 0}

        def enc(b):  # alternate the two encoders of the pool
            turn["p"] += 1
            return encs[turn["p"] % 2](b)

        def jenc(b):
            turn["j"] += 1
            return jencs[turn["j"] % 2](b)
    else:
        raise KeyError(name)
    return stream, enc, jenc, W.decode_aliccp_batch, JW.decode_aliccp_batch


CASES = ["criteo_after_mapper", "aliccp_padded", "aliccp_padded_wide_vocab", "aliccp_real_vals",
         "aliccp_mh_coo_counts", "aliccp_mh_coo_combine", "lohi_bits", "lohi_u8", "shared_state"]


@pytest.mark.parametrize("case", CASES)
def test_encoder_bytes_equal_jax_and_decode_is_exact(case):
    stream, enc, jenc, dec, jdec = _case(case)
    for b in stream:
        ref = {k: np.array(v) for k, v in b.items()}
        wire, jwire = enc(dict(b)), jenc(dict(b))
        _same_wire(wire, jwire)
        got = _decode(wire, dec)
        _exact(got, _jax_decode(jwire, jdec))
        if case.startswith("aliccp") or case == "shared_state":
            ref.setdefault("label", ref.get("y"))
            # the counts stay in the decoded batch, as int32; the compact
            # stream is dropped with dest (rebuilt from the counts on the device)
            ref.pop(MHC_CDEST, None)
            if MHC_CNT in wire:
                ref[MHC_CNT] = ref[MHC_CNT].astype(np.int32)
        if case.startswith("lohi"):
            ref["label"] = ref["y"]
        _exact(got, ref)
    if case == "lohi_bits":
        assert wire[W.MHC_HI].shape[-1] == 64 // 8 and wire[W.MHC_LO].dtype == np.uint16
    if case == "lohi_u8":
        assert wire[W.MHC_HI].shape[-1] == 64 and wire[W.MHC_HI].dtype == np.uint8
    if case == "aliccp_mh_coo_counts":
        assert MHC_W not in wire and MHC_DEST not in wire and wire[MHC_CNT].dtype == np.uint16
        assert wire[MHC_IDX].dtype == np.uint16
    if case == "aliccp_mh_coo_combine":
        assert MHC_W in wire
    if case == "aliccp_real_vals":
        assert "u_catvals" in wire and "u_shopvals" not in wire


def test_criteo_wire_is_164_bytes_an_example():
    b = synthetic_criteo_batch(np.random.default_rng(0), 64, 400)
    full = sum(np.asarray(v).nbytes for v in b.values()) / 64
    slim = sum(np.asarray(v).nbytes for v in W.encode_batch(b, 13).values()) / 64
    assert (full, slim) == (320.0, 164.0)


def _raises_as_jax(fn, jfn, match):
    with pytest.raises(ValueError, match=match) as got:
        fn()
    with pytest.raises(ValueError, match=match) as want:
        jfn()
    assert str(got.value) == str(want.value)


def test_contract_violations_raise_jax_errors():
    b = synthetic_criteo_batch(np.random.default_rng(0), 8, 400)
    bad = dict(b, feat_ids=b["feat_ids"].copy())
    bad["feat_ids"][0, 2] = 7
    _raises_as_jax(lambda: W.encode_batch(bad, 13), lambda: JW.encode_batch(bad, 13),
                   "not the constant 1..sf")
    bad = dict(b, feat_vals=b["feat_vals"].copy())
    bad["feat_vals"][1, 20] = 0.5
    _raises_as_jax(lambda: W.encode_batch(bad, 13), lambda: JW.encode_batch(bad, 13),
                   "not all exactly 1.0")

    def mid_run(make_enc, first, bad):
        enc = make_enc()
        enc(dict(first))
        return lambda: enc(dict(bad))

    first, bad = _ali(0), dict(_ali(1))
    bad["u_catvals"] = bad["u_catvals"] * np.float32(3.0)
    _raises_as_jax(mid_run(lambda: W.AliccpSlimEncoder(400), first, bad),
                   mid_run(lambda: JW.AliccpSlimEncoder(400), first, bad), "u_catvals")
    model = create_model(Config(**ESMM))
    ngr = len(model.mh_coo_groups())
    s0, s1 = _coo_stream(model, seeds=range(2))
    wbad = dict(s1, **{MHC_W: np.asarray(s1[MHC_W]) * np.float32(2.0)})
    _raises_as_jax(mid_run(lambda: W.AliccpSlimEncoder(400, n_groups=ngr), s0, wbad),
                   mid_run(lambda: JW.AliccpSlimEncoder(400, n_groups=ngr), s0, wbad),
                   "__mhc_w stopped being")
    dbad = dict(s1)
    d = np.asarray(s1[MHC_DEST]).copy()
    nlive = int(np.flatnonzero(np.asarray(s1[MHC_IDX])[0]).max()) + 1
    d[0, :nlive] = d[0, :nlive][::-1]
    dbad[MHC_DEST] = d
    _raises_as_jax(mid_run(lambda: W.AliccpSlimEncoder(400, n_groups=ngr), s0, dbad),
                   mid_run(lambda: JW.AliccpSlimEncoder(400, n_groups=ngr), s0, dbad),
                   "dest stream stopped")
    # a first batch off the packer's order keeps dest and drops the counts
    wire = W.AliccpSlimEncoder(400, n_groups=ngr)(dict(dbad))
    assert MHC_DEST in wire and MHC_CNT not in wire and MHC_CDEST not in wire


def test_harness_refusals_as_jax(tmp_path):
    from tf_repos_tpu.train.harness import Harness as JaxHarness

    common = dict(field_size=39, embedding_size=4, deep_layers="8,4", dropout="1.0,1.0",
                  slim_transfer=True, model_dir=str(tmp_path), dt_dir="x")
    for model, match in (("DeepFM", "requires --static_fields>0"),
                         ("wide_n_deep", "supports libsvm and aliccp")):
        _raises_as_jax(lambda: Harness(Config(model=model, feature_size=400, device="cpu", **common)),
                       lambda: JaxHarness(JaxConfig(model=model, feature_size=400, **common)), match)


# --------------------------------------------------------------- harness runs
DEEPFM_FLAGS = ["--model=DeepFM", "--feature_size=500", "--field_size=39", "--embedding_size=4",
                "--deep_layers=8,4", "--dropout=1.0,1.0", "--batch_size=32", "--learning_rate=0.01",
                "--sparse_table_update=true", "--fused_table=true", "--static_fields=13",
                "--sparse_catchup=true"]
ALI_COMMON = ["--feature_size=700", "--field_size=11", "--embedding_size=4", "--deep_layers=8,4",
              "--dropout=1.0,1.0", "--batch_size=16", "--learning_rate=0.01",
              "--sparse_table_update=true", "--fused_table=true", "--mh_coo=true",
              "--multi_hot_pad=16", "--mh_coo_floor=1024", "--sparse_pad_mode=pow2:700"]
RUNS = {
    # (port flags, JAX flags beside the common ones, train lines)
    "DeepFM": (DEEPFM_FLAGS + ["--pallas_expand=true"], DEEPFM_FLAGS, 150),
    "ESMM": (["--model=ESMM", *ALI_COMMON, "--map_workers=2", "--pallas_expand=true"],
             ["--model=ESMM", *ALI_COMMON, "--map_workers=2"], 88),
    "DIN": (["--model=DIN", "--attention_layers=8", *ALI_COMMON, "--mh_bucket=pow2",
             "--pallas_expand=true"],
            ["--model=DIN", "--attention_layers=8", *ALI_COMMON, "--mh_bucket=pow2"], 88),
}


def _write(model, d):
    d.mkdir(exist_ok=True)
    if model == "DeepFM":
        write_synthetic_libsvm(str(d / "tr.libsvm"), 150, feature_size=500, seed=1, zipf_a=1.2)
        write_synthetic_libsvm(str(d / "va.libsvm"), 64, feature_size=500, seed=2, zipf_a=1.2)
    else:
        lens = {k: v / 25 for k, v in PUBLISHED_MH_AVG_LENS.items()}
        write_synthetic_aliccp(str(d / "tr.samples.txt"), 88, feature_size=700, seed=1,
                               mh_avg_lens=lens, zipf_a=1.2)
        write_synthetic_aliccp(str(d / "va.samples.txt"), 40, feature_size=700, seed=2,
                               mh_avg_lens=lens, zipf_a=1.2)


def _losses(model_dir):
    recs = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
    return [r["loss"] for r in recs if r["kind"] == "train"]


@pytest.mark.parametrize("model", list(RUNS))
def test_decoded_training_batches_equal_the_full_ones(tmp_path, model):
    d = tmp_path / "d"
    _write(model, d)
    flags = [*RUNS[model][0], f"--data_dir={d}", f"--model_dir={tmp_path}/m/", "--device=cpu",
             "--num_epochs=1"]
    batches = {}
    for slim in (False, True):
        h = Harness(parse_config(flags + [f"--slim_transfer={slim}"]))
        got = []
        for split in ("tr", "va"):
            for b in h._dataset(split, shuffle=split == "tr", epochs=1):
                t = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                if slim:
                    assert isinstance(h.model, W.SlimWireModel)
                    t = h.model._decode(t)
                got.append(t)
        batches[slim] = got
    full, slim = batches[False], batches[True]
    assert len(full) == len(slim) > 2
    for f, s in zip(full, slim):
        f = dict(f)
        if model == "DIN":  # the compact stream: the packer's, or rebuilt in the model
            f.pop(MHC_CDEST, None)
        if MHC_CNT in s and MHC_CNT in f:
            assert torch.equal(s[MHC_CNT], f[MHC_CNT].to(torch.int32))
            f[MHC_CNT] = s[MHC_CNT]
        assert sorted(s) == sorted(f)
        for k in f:
            assert s[k].dtype == f[k].dtype and torch.equal(s[k], f[k]), k


@pytest.mark.parametrize("model", list(RUNS))
def test_slim_trajectory_equals_full_and_matches_jax(tmp_path, model):
    port_flags, jax_flags, _ = RUNS[model]
    src = tmp_path / "src"
    _write(model, src)
    common = ["--task_type=train", "--num_epochs=1", "--log_steps=1", "--eval_throttle_secs=0",
              "--compute_dtype=float32", "--seed=5", "--dt_dir=x"]
    dirs = {}
    for who in ("jax", "slim", "full"):
        shutil.copytree(src, tmp_path / f"data_{who}")
        dirs[who] = tmp_path / f"data_{who}"
    argv = {
        "jax": [*jax_flags, *common, "--slim_transfer=true", f"--data_dir={dirs['jax']}",
                f"--model_dir={tmp_path}/jm/"],
        "slim": [*port_flags, *common, "--slim_transfer=true", f"--data_dir={dirs['slim']}",
                 f"--model_dir={tmp_path}/slim/", "--device=cpu"],
        "full": [*port_flags, *common, f"--data_dir={dirs['full']}", f"--model_dir={tmp_path}/full/",
                 "--device=cpu"],
    }
    cfg = parse_config(argv["slim"])
    jcfg = JaxConfig(**{k: v for k, v in vars(cfg).items() if k != "device"})
    jp, js = jax_create_model(jcfg).init(jax.random.PRNGKey(jcfg.seed))
    tp, tm = params_from_jax(jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))
    for who in ("slim", "full"):
        h = Harness(parse_config(argv[who]))
        state = h.init_train_state()
        for dst, s in zip(tree_leaves(state["params"]), tree_leaves(tp)):
            dst.copy_(s)
        state["mstate"] = tm
        CheckpointManager(h.model_dir).save(0, state)
    want = JAX_CLI.main(argv["jax"])
    got = {who: CLI.main(argv[who]) for who in ("slim", "full")}
    losses = {who: _losses(f"{tmp_path}/{d}/x") for who, d in
              (("jax", "jm"), ("slim", "slim"), ("full", "full"))}
    assert len(losses["slim"]) == len(losses["jax"]) >= 5
    assert losses["slim"] == losses["full"]
    assert got["slim"] == {**got["full"], "wall_time": got["slim"]["wall_time"]}
    np.testing.assert_allclose(losses["slim"], losses["jax"], rtol=2e-5)
    np.testing.assert_allclose(got["slim"]["loss"], want["loss"], rtol=2e-5)
    # export writes the wrapped model (the wire is no serving signature)
    path = CLI.main([a for a in argv["slim"] if a != "--task_type=train"] + ["--task_type=export"])
    meta = json.load(open(os.path.join(path, "saved_model.json")))
    assert meta["model"] == model and "__slim_cat_ids" not in meta["inputs"]


# ------------------------------------------------------------------- presets
PRESETS = {
    "criteo_headline": ("libsvm", ["--model=DeepFM", "--feature_size=400", "--field_size=39"]),
    "criteo_singlepass": ("libsvm", ["--model=DeepFM", "--feature_size=400", "--field_size=39"]),
    "esmm_large_vocab": ("aliccp", ["--model=ESMM", "--feature_size=600", "--field_size=11"]),
    "din_large_vocab": ("aliccp", ["--model=DIN", "--feature_size=600", "--field_size=11",
                                   "--attention_layers=8"]),
}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_preset_trains_evaluates_and_exports(tmp_path, preset):
    fmt, flags = PRESETS[preset]
    d = tmp_path / "d"
    d.mkdir()
    if fmt == "libsvm":
        write_synthetic_libsvm(str(d / "tr.libsvm"), 32, feature_size=400, seed=0)
        write_synthetic_libsvm(str(d / "va.libsvm"), 16, feature_size=400, seed=1)
    else:
        write_synthetic_aliccp(str(d / "tr.samples.txt"), 32, feature_size=600, seed=0)
        write_synthetic_aliccp(str(d / "va.samples.txt"), 16, feature_size=600, seed=1)
    argv = [f"--preset={preset}", *flags, "--embedding_size=4", "--deep_layers=8,4",
            "--dropout=1.0,1.0", "--batch_size=16", "--num_epochs=1", "--log_steps=1",
            f"--data_dir={d}", f"--model_dir={tmp_path}/m/", "--dt_dir=x", "--eval_throttle_secs=0",
            "--device=cpu"]
    res = CLI.main(["--task_type=train", *argv])
    assert res["step"] == 2 and np.isfinite(res["loss"])
    ev = CLI.main(["--task_type=eval", *argv])
    assert ev["loss"] == pytest.approx(res["loss"], rel=1e-6)
    path = CLI.main(["--task_type=export", *argv])
    assert os.path.isdir(path)
    # the servable (f32 tables, the wrapped model's signature; a pad of 0
    # under --multi_hot_pad=0) loads, warms up and scores
    scorer = Scorer(os.path.dirname(path), batch_buckets=(4,), device="cpu")
    assert all(v.dtype == torch.float32 for v in tree_leaves(scorer.params))
    if fmt == "libsvm":
        b = synthetic_criteo_batch(np.random.default_rng(0), 4, 400)
        inst = [{"feat_ids": b["feat_ids"][i], "feat_vals": b["feat_vals"][i]} for i in range(4)]
    else:
        b = synthetic_aliccp_batch(np.random.default_rng(0), 4, 600, multi_hot_pad=16)
        inst = [{k: b[k][i] for k in scorer.signature["inputs"]} for i in range(4)]
    out = scorer.score(inst)
    assert all(np.all(np.isfinite(v)) and len(v) == 4 for v in out.values())
    cfg = parse_config(argv)
    h = Harness(cfg)
    assert isinstance(h.model, W.SlimWireModel) == cfg.slim_transfer
    state = CheckpointManager(h.model_dir).restore("cpu")
    bf16 = cfg.param_dtype in ("bfloat16", "bf16")
    tables = list(h.model.sparse_slots())
    assert all((state["params"][t].dtype == torch.bfloat16) == bf16 for t in tables)
