"""Whole-zoo default-hypers AUC ladder on the Criteo surrogate, on the
PyTorch port (the port of scripts/zoo_auc.py): the behavioural analog
of the reference's published per-model TensorBoard curves
(deep_ctr/uploads/tensorboard_auc.png, embedded at deep_ctr/README.md:38):
DCN 0.793 > LR 0.777 > IPNN 0.771 > DeepFM 0.769 > wide_n_deep 0.767 >
FNN 0.766 > NFM 0.765 > OPNN 0.743 > AFM 0.731.

Each model trains with the reference's per-model command line
(deep_ctr/run.sh:12-22) through the port's harness on the surrogate of
tf_repos_tpu_torch/data/criteo_surrogate.py (2,000,000 lines by
default, from a seed), preprocessed by features/criteo.py. The
wide/wide_n_deep rows read a CSV view of the raw surrogate (label,
I1..I13, C14..C39 as per-field frequency ranks < 10,000: the
identity-column contract of wide_n_deep.py:96-97) with the canned
estimators' composite optimizer (wide FTRL, deep Adagrad).

Results go to --out (default ZOO_AUC_H100.json at the repo root; a
relative path is repo-rooted, an absolute one is used as it is) after
every row, with each row's wall time and the device it ran on (the
card's name and power limit, or cpu); a rerun with the same
--train_lines skips the rows already in that file. The report, the
setup line and the table, goes beside it (ZOO_AUC_H100.md). The JAX
package's records, ZOO_AUC.json and ZOO_AUC.md, are never written. A row
that raises is recorded with its error and the ladder goes on.

The surrogate, its libsvm files and the csv view are made in --work_dir
(default: criteo_parity_torch_<train_lines>_<test_lines> in the temp
directory, which honours TMPDIR) and reused by a later run only when the
stamp written beside them (lines.json) names the same --train_lines and
--test_lines; otherwise they are made again.

    python scripts/torch_zoo_auc.py [--train_lines 2000000] [--models DCN,AFM] [--device cpu]

--device defaults to cuda and raises without a GPU; only --device=cpu
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tf_repos_tpu_torch.utils.platform import card_label, resolve_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = "ZOO_AUC_H100.json"
# the JAX package's ladders: never this script's output
JAX_RECORDS = ("ZOO_AUC.json", "ZOO_AUC.md", "ZOO_AUC_45M.json")

# (name, model, published AUC, reference command line: deep_ctr/run.sh)
LADDER = [
    ("DCN", "DCN", 0.793,
     dict(learning_rate=1e-4, embedding_size=32, batch_size=256,
          deep_layers="512,256", cross_layers=3, dropout="0.8,0.8", l2_reg=1e-5)),
    # wdl rows: no learning_rate. The reference's flag is commented out
    # (wide_n_deep.py:37) and the canned estimators derive their own
    # rates (train/optimizers.canned_wdl_rates: LinearClassifier FTRL
    # 0.1601; DNNLinearCombined 0.005/0.001)
    ("LR", "wide", 0.777,
     dict(optimizer="wdl", batch_size=128,
          deep_layers="256,128,64", dropout="1.0,1.0,1.0")),
    ("IPNN", "ipnn", 0.771,
     dict(learning_rate=1e-4, embedding_size=32, batch_size=256,
          deep_layers="256,128", dropout="0.8,0.8", l2_reg=1e-4)),
    ("DeepFM", "DeepFM", 0.769,
     dict(learning_rate=1e-4, embedding_size=32, batch_size=256,
          deep_layers="256,128", dropout="0.8,0.8", l2_reg=1e-4)),
    ("wide_n_deep", "wide_n_deep", 0.767,
     dict(optimizer="wdl", embedding_size=32, batch_size=128,
          deep_layers="256,128,64", dropout="1.0,1.0,1.0")),
    ("FNN", "fnn", 0.766,
     dict(learning_rate=1e-4, embedding_size=32, batch_size=256,
          deep_layers="256,128", dropout="0.8,0.8", l2_reg=1e-4)),
    ("NFM", "NFM", 0.765,
     dict(learning_rate=5e-5, embedding_size=256, batch_size=128,
          deep_layers="256,128", dropout="0.5,0.5,0.5", l2_reg=1e-3,
          batch_norm=True)),
    ("OPNN", "opnn", 0.743,
     dict(learning_rate=1e-4, embedding_size=32, batch_size=256,
          deep_layers="256,128", dropout="0.8,0.8", l2_reg=1e-4)),
    ("AFM", "AFM", 0.731,
     dict(learning_rate=5e-4, embedding_size=256, batch_size=128,
          attention_layers="128", dropout="0.5,0.5", l2_reg=1e-3)),
    ("DeepMVM", "DeepMVM", None,
     dict(learning_rate=1e-4, embedding_size=32, batch_size=256,
          deep_layers="256,128", dropout="0.8,0.8", l2_reg=1e-4)),
]


def make_csv_view(raw_train: str, csv_dir: str) -> None:
    """Raw surrogate TSV -> the wide_n_deep CSV contract: label, I1..I13
    floats, C14..C39 identity ids in [1, 10000) (identity buckets,
    default 0: wide_n_deep.py:96-97). The reference consumed an already
    preprocessed CSV (its column defaults are float/int, :60-63), whose
    categorical columns are per-field frequency-ranked ids: under the
    10,000 identity buckets the 10k hottest values of each field keep
    their identity and only the rare tail shares the default bucket 0.
    Continuous columns get the clip-then-min-max normalisation of the
    libsvm pipeline (get_criteo_feature.py:64-91). 90/10 split."""
    from collections import Counter

    from tf_repos_tpu_torch.features.criteo import ContinuousFeatureGenerator

    os.makedirs(csv_dir, exist_ok=True)
    cg = ContinuousFeatureGenerator()
    counts = [Counter() for _ in range(26)]
    with open(raw_train) as f:
        for line in f:
            toks = line.rstrip("\n").split("\t")
            cg.accumulate(toks, 1)
            for j, t in enumerate(toks[14:40]):
                if t:
                    counts[j][t] += 1
    # per-field frequency rank (1-based; ties broken by value for
    # determinism); rank >= 10000 falls to the default bucket 0
    ranks = [
        {v: r + 1 for r, (v, _) in enumerate(
            sorted(c.items(), key=lambda kv: (-kv[1], kv[0]))[:9999]
        )}
        for c in counts
    ]
    with open(os.path.join(csv_dir, "tr.csv"), "w") as tr, \
            open(os.path.join(csv_dir, "va.csv"), "w") as va, open(raw_train) as f:
        for i, line in enumerate(f):
            toks = line.rstrip("\n").split("\t")
            conts = [f"{cg.gen(j, t):.6f}" for j, t in enumerate(toks[1:14])]
            cats = [
                str(ranks[j].get(t, 0)) if t else "0"
                for j, t in enumerate(toks[14:40])
            ]
            out = ",".join([toks[0]] + conts + cats)
            (va if i % 10 == 9 else tr).write(out + "\n")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train_lines", type=int, default=2_000_000)
    ap.add_argument("--test_lines", type=int, default=200_000)
    ap.add_argument("--work_dir", default="",
                    help="surrogate and model dirs (default: work_dir_for(train, test lines))")
    ap.add_argument("--models", default="", help="comma filter of ladder names")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="results json (relative: repo-rooted); the .md report goes beside it")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a GPU) or cpu")
    return ap


def out_paths(out: str):
    """(json path, report path) of --out; refuses the JAX package's records."""
    if not out.endswith(".json"):
        raise ValueError(f"--out {out!r}: a .json path")
    json_path = out if os.path.isabs(out) else os.path.join(REPO, out)
    md_path = json_path[: -len(".json")] + ".md"
    taken = {os.path.realpath(os.path.join(REPO, r)) for r in JAX_RECORDS}
    for path in (json_path, md_path):
        if os.path.realpath(path) in taken:
            raise ValueError(f"--out {out!r} would write {path}, a record of the JAX package")
    return json_path, md_path


def work_dir_for(train_lines: int, test_lines: int) -> str:
    """The default --work_dir: one a line count, in the temp directory."""
    return os.path.join(tempfile.gettempdir(), f"criteo_parity_torch_{train_lines}_{test_lines}")


def work_paths(work_dir: str):
    """(raw dir, libsvm dir, csv dir) of a work dir."""
    return (os.path.join(work_dir, "raw"), os.path.join(work_dir, "proc"),
            os.path.join(work_dir, "csv"))


STAMP = "lines.json"


def read_stamp(work_dir: str):
    """The line counts the work dir's files were made from, or None."""
    try:
        with open(os.path.join(work_dir, STAMP)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_stamp(work_dir: str, train_lines: int, test_lines: int) -> None:
    """Say that the work dir's raw, libsvm and csv files are made from
    these line counts (after they are complete)."""
    with open(os.path.join(work_dir, STAMP), "w") as f:
        json.dump({"train_lines": train_lines, "test_lines": test_lines}, f)


def row_config(row, feature_size: int, work_dir: str, epochs: int = 1, device: str = "cuda"):
    """The harness Config of one LADDER row: its published flags on the
    libsvm files (the csv view for the wdl rows), one epoch, the final
    eval only."""
    from tf_repos_tpu_torch.config import Config

    name, model, _, hp = row
    _, proc, csv_dir = work_paths(work_dir)
    kw = dict(
        model=model, feature_size=feature_size, field_size=39,
        num_epochs=epochs, log_steps=1000, optimizer="Adam",
        data_dir=csv_dir if hp.get("optimizer") == "wdl" else proc,
        model_dir=os.path.join(work_dir, f"zoo_{name}"), dt_dir="z",
        eval_throttle_secs=0, clear_existing_model=True,
        steps_per_dispatch=64, packed_cache=True, device=device,
    )
    kw.update(hp)
    return Config(**kw)


def main(argv=None):
    a = parser().parse_args(argv)
    dev = resolve_device(a.device)
    card = card_label(dev)
    json_path, md_path = out_paths(a.out)

    from tf_repos_tpu_torch.data import criteo_surrogate as CS
    from tf_repos_tpu_torch.features.criteo import preprocess
    from tf_repos_tpu_torch.train.harness import run_task

    CS.configure(a.train_lines)
    work_dir = a.work_dir or work_dir_for(a.train_lines, a.test_lines)
    data, out, csv_dir = work_paths(work_dir)
    lines = {"train_lines": a.train_lines, "test_lines": a.test_lines}
    if read_stamp(work_dir) != lines:
        # files of other line counts, or of a run cut short: make them anew
        for d in (data, out, csv_dir):
            shutil.rmtree(d, ignore_errors=True)
        if os.path.exists(os.path.join(work_dir, STAMP)):
            os.remove(os.path.join(work_dir, STAMP))
    os.makedirs(data, exist_ok=True)
    raw_train = os.path.join(data, "train.txt")
    t0 = time.time()
    if not os.path.exists(raw_train):
        CS.generate_raw(raw_train, a.train_lines, seed=0)
        CS.generate_raw(os.path.join(data, "test.txt"), a.test_lines, seed=1)
    if not os.path.exists(os.path.join(out, "feature_map")):
        # the workers' output is byte-identical to one process's
        stats = preprocess(data, out, cutoff=CS.scaled_cutoff(a.train_lines),
                           workers=os.cpu_count() or 1)
        feature_size = stats["feature_size"]
    else:
        feature_size = sum(1 for _ in open(os.path.join(out, "feature_map")))
    if not os.path.exists(os.path.join(csv_dir, "tr.csv")):
        make_csv_view(raw_train, csv_dir)
    write_stamp(work_dir, a.train_lines, a.test_lines)

    # finished rows come only from this script's own --out, for the same
    # data; the ceiling depends on train_lines alone
    results = None
    if os.path.exists(json_path):
        with open(json_path) as f:
            prior = json.load(f)
        if (prior.get("train_lines"), prior.get("feature_size")) == (a.train_lines, feature_size):
            results = prior
    if results is None:
        results = {"train_lines": a.train_lines, "feature_size": feature_size,
                   "bayes_ceiling": round(CS.bayes_ceiling(), 4), "runs": {}}
    ceiling = results["bayes_ceiling"]
    print(f"[setup] {time.time() - t0:.0f}s feature_size={feature_size} ceiling={ceiling:.4f}"
          f" on {card}")

    def dump():
        with open(json_path, "w") as f:
            json.dump(results, f, indent=1)

    only = {m for m in a.models.split(",") if m}
    for row in LADDER:
        name, model, ref_auc, hp = row
        if only and name not in only:
            continue
        if name in results["runs"]:
            print(f"[skip] {name} (cached in {os.path.basename(json_path)})")
            continue
        cfg = row_config(row, feature_size, work_dir, a.epochs, a.device)
        t0 = time.time()
        try:
            m = run_task(cfg)
        except Exception as e:  # keep the ladder going past one bad row
            print(f"[FAIL] {name}: {type(e).__name__}: {e}")
            results["runs"][name] = {"error": f"{type(e).__name__}: {e}"[:500]}
            dump()
            continue
        rec = {
            "model": model, "ref_auc": ref_auc, "auc": round(m["auc"], 4),
            "pct_of_ceiling": round(100.0 * m["auc"] / ceiling, 2),
            "wall_s": round(time.time() - t0, 1), "device": card, **hp,
        }
        results["runs"][name] = rec
        dump()
        print(f"[zoo] {name}: auc={rec['auc']:.4f} ({rec['pct_of_ceiling']:.1f}% of ceiling) "
              f"in {rec['wall_s']} s on {card}")

    dump()
    write_report(results, md_path)
    print("ZOO " + json.dumps({k: v.get("auc") for k, v in results["runs"].items()}))
    return results


def write_report(results: dict, path: str) -> None:
    ceiling = results["bayes_ceiling"]
    lines = [
        "# Model-zoo default-hypers AUC ladder on the PyTorch port (scripts/torch_zoo_auc.py)",
        "",
        f"Surrogate: {results['train_lines']:,} lines, feature_size "
        f"{results['feature_size']:,}, Bayes ceiling {ceiling:.4f}. Each row "
        "is the reference's per-model command line (deep_ctr/run.sh:12-22) "
        "through the port's harness; published AUCs from "
        "deep_ctr/uploads/tensorboard_auc.png (real Criteo).",
        "",
        "| model | published AUC (real Criteo) | surrogate AUC | % of ceiling | wall s | device |",
        "|---|---|---|---|---|---|",
    ]
    runs = {k: v for k, v in results["runs"].items() if "auc" in v}
    for name, r in sorted(runs.items(), key=lambda kv: -kv[1]["auc"]):
        ref = f"{r['ref_auc']:.3f}" if r.get("ref_auc") else "—"
        lines.append(f"| {name} | {ref} | {r['auc']:.4f} | {r['pct_of_ceiling']:.1f}% | "
                     f"{r['wall_s']} | {r['device']} |")
    for name, r in results["runs"].items():
        if "error" in r:
            lines.append(f"| {name} | — | FAILED | {r['error'][:80]} | — | — |")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
