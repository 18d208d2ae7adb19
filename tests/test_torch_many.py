"""The port's "(many)" repeat study (transformer_stm_tpu_torch/train/many.py)
against the JAX package's (the JAX multi tests need the reference
checkout's data, tests/test_multi.py:15-17).

Fixture: ``test_torch_data.write_fixture`` (2 groups x 5 pieces x 4 layers
of 32x32) with the corpus in the decode cache, where both packages'
trainers and ``test_target`` read it, and the tiny CvT of
tests/test_torch_multi.py at dropout 0 and batch = rows_max (one step an
epoch).  Both packages resume from one JAX epoch-0 stacked checkpoint at
``many_{freq}.ckpts`` and train 2 repeats for 2 epochs: JAX on its XLA
attention and MLP, the port on its defaults (``impl="small"``,
``mlp_impl="pallas"``), whose kernels run their plain versions on the CPU.
The per-repeat r2, mse and mae and the stats agree within 1e-4 relative;
the artifacts' paths and the summary's keys are equal; the port's caller
watchdog sees every deadline in order.  ``main`` takes
scripts/train_many.py's arguments, configuration and environment.
"""

import json
import os
import shutil

import numpy as np
import pytest

from transformer_stm_tpu import config as jc
from transformer_stm_tpu.train.many import run_many as jax_run_many
from transformer_stm_tpu.train.multi import \
    MultiTargetTrainer as JaxMultiTargetTrainer
from transformer_stm_tpu_torch import config as pc
from transformer_stm_tpu_torch.data.images import _cache_paths
from transformer_stm_tpu_torch.train import many
from transformer_stm_tpu_torch.train.watchdog import HangWatchdog

from test_torch_data import write_fixture
from test_torch_multi import experiment

RTOL = 1e-4
FREQ = "50HZ_Bm"
REPEATS, EPOCHS = 2, 2


def cache_fixture(root):
    """write_fixture's sheets and corpus, the corpus in the decode cache."""
    fields, corpus = write_fixture(root)
    npy, meta = _cache_paths(pc.DataConfig(**fields))
    os.makedirs(fields["cache_dir"])
    np.save(npy, corpus)
    with open(meta, "w") as f:
        json.dump({"decoded": list(range(corpus.shape[0]))}, f)
    return fields


def ckpt_dir(cfg):
    return os.path.join(cfg.result_dir, "Weight", cfg.variant_dir,
                        f"many_{FREQ}.ckpts")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("many"))
    fields = cache_fixture(root)
    jcfg = experiment(jc, fields, os.path.join(root, "jax"), 32)
    pcfg = experiment(pc, fields, os.path.join(root, "port"), 32)
    targets = [(FREQ, 1000 + t, t) for t in range(1, REPEATS + 1)]
    JaxMultiTargetTrainer(jcfg, targets).save(ckpt_dir(jcfg))
    shutil.copytree(ckpt_dir(jcfg), ckpt_dir(pcfg))
    want = jax_run_many(jcfg, FREQ, EPOCHS, REPEATS, impl="xla",
                        mlp_impl="xla", verbose=False)
    labels = []
    wd = HangWatchdog(timeout_s=600, poll_s=0.1)
    dispatch = wd.dispatch
    wd.dispatch = lambda label: labels.append(label) or dispatch(label)
    got = many.run_many(pcfg, FREQ, EPOCHS, REPEATS, watchdog=wd,
                        verbose=False, device="cpu")
    running = wd._thread is not None
    wd.stop()
    return dict(jcfg=jcfg, pcfg=pcfg, want=want, got=got, labels=labels,
                running=running)


def test_repeats_and_stats_match_jax(both):
    got, want = both["got"], both["want"]
    assert got.keys() == want.keys()
    assert (got["freq"], got["epochs"], got["repeats"]) == \
        (want["freq"], want["epochs"], want["repeats"]) == \
        (FREQ, EPOCHS, REPEATS)
    assert [(r["time"], r["seed"]) for r in got["runs"]] == \
        [(r["time"], r["seed"]) for r in want["runs"]] == [(1, 1001),
                                                           (2, 1002)]
    for g, w in zip(got["runs"], want["runs"]):
        assert g.keys() == w.keys()
        for k in ("r2", "mse", "mae"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=0,
                                       err_msg=k)
    assert got["stats"].keys() == want["stats"].keys()
    for k, st in want["stats"].items():
        assert got["stats"][k].keys() == st.keys()
        for s in st:
            np.testing.assert_allclose(got["stats"][k][s], st[s], rtol=RTOL,
                                       atol=0, err_msg=f"{k} {s}")
    r2 = np.array([r["r2"] for r in got["runs"]])
    assert got["stats"]["r2"]["std"] == pytest.approx(r2.std(ddof=1),
                                                      rel=1e-12)


def test_summary_file_and_artifacts_match_jax(both):
    jcfg, pcfg = both["jcfg"], both["pcfg"]
    name = f"cvt_many_{FREQ}_summary.json"
    with open(os.path.join(pcfg.result_dir, name)) as f:
        assert json.load(f) == json.loads(json.dumps(both["got"]))
    assert os.path.exists(os.path.join(jcfg.result_dir, name))
    # each repeat's weights, records, metrics sheet (and plots) under its
    # _{t} name, and the stacked checkpoints, under the same paths
    mine, theirs = _files(pcfg.result_dir), _files(jcfg.result_dir)
    assert mine == theirs
    for t in range(1, REPEATS + 1):
        assert f"Excel/Images & Parameters/Predictions_Metrics_{FREQ}_{t}" \
            ".xlsx" in mine
    assert f"Weight/Images & Parameters/many_{FREQ}.ckpts/" \
        "ckpt_000002.npz" in mine


def test_caller_watchdog_guards_every_dispatch(both):
    assert both["labels"] == [
        "trainer init / first device contact",
        "corpus upload / device init", "multi-epoch @ 0",
        "checkpoint @ 2", "weight export", "eval time=1", "eval time=2"]
    assert both["running"]  # fit left the caller's watchdog running


@pytest.mark.parametrize("env,watchdog", [({"TSTM_WATCHDOG_S": "0"}, False),
                                          ({"TSTM_WATCHDOG_S": "5",
                                            "TSTM_MULTI_IMPL": "xla",
                                            "TSTM_MULTI_MLP": "xla"}, True)])
def test_main_takes_the_scripts_arguments(monkeypatch, env, watchdog):
    calls = []

    def fake(cfg, freq, epochs, repeats, **kw):
        calls.append((cfg, freq, epochs, repeats, kw))
        return {"stats": {}}

    monkeypatch.setattr(many, "run_many", fake)
    for k in ("TSTM_WATCHDOG_S", "TSTM_MULTI_IMPL", "TSTM_MULTI_MLP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    many.main(["50HZ_Hc", "7", "3"])
    (cfg, freq, epochs, repeats, kw), = calls
    assert (freq, epochs, repeats) == ("50HZ_Hc", 7, 3)
    assert cfg.inputs == "img+par" and cfg.frequencies == ("50HZ_Hc",)
    assert (cfg.train.epochs, cfg.train.batch_size,
            cfg.train.compute_dtype) == (7, 128, "bfloat16")
    assert cfg.result_dir == "Result"
    assert (kw["impl"], kw["mlp_impl"]) == (
        env.get("TSTM_MULTI_IMPL", "small"),
        env.get("TSTM_MULTI_MLP", "pallas"))
    wd = kw["watchdog"]
    assert (wd is not None) == watchdog
    if wd is not None:
        assert wd.timeout_s == 5.0 and wd._thread is not None
        wd.stop()
    del calls[:]
    many.main([])
    assert calls[0][1:4] == ("50HZ_Bm", 1000, 8)
    if calls[0][4]["watchdog"] is not None:
        calls[0][4]["watchdog"].stop()
