"""The port's training path against the JAX package's: token packing,
``loss_fn`` and its gradients, the train step and the ``Trainer``.

Inputs are made from seeded NumPy and the reference's weights are carried
across (``params_from_numpy``, or the reference's own checkpoint).
Tolerances, all float32 sums in another order:

* ``pack_tokens``: bit for bit (a NumPy copy);
* ``loss_fn`` on the smoke config of every arch (a Mamba layer's SSD
  through the ``ssd_scan`` autograd Function), remat on and off: the loss and its NLL and aux terms within 1e-6
  relative, every gradient leaf within 1e-5 of that leaf's largest
  reference magnitude (measured: 5e-7 and 1.5e-6);
* ``make_train_step`` of olmo-1b and of mamba2-1.3b, 1 and 2
  microbatches, 3 steps: loss, grad norm and lr within 1e-5 relative,
  parameters within 1e-5;
* the ``Trainer``, 12 steps from the reference's step-0 checkpoint: every
  step's loss within 1e-5 relative and the final parameters within 1e-5
  (measured: 1.6e-7 and 7.6e-8).

The reference's own trainer checks (``tests/test_checkpoint_train.py``)
run on the port alone: the loss decreases, failure recovery is bit-exact,
DV-DVFS saves simulated energy.
"""
import shutil
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.data import BlockDataset as JBlockDataset
from repro.data import pack_tokens as j_pack_tokens
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import linear_warmup_cosine as j_lr
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train import make_train_step as j_make_train_step
import repro_torch.configs as tcfg
from repro_torch.data import BlockDataset, pack_tokens
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TT
from repro_torch.models.convert import flatten, params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine
from repro_torch.train import TrainConfig, Trainer, make_train_step
from repro_torch.tree import tree_leaves, tree_map

LOSS_ARCHS = ("olmo-1b", "yi-6b", "minitron-8b", "qwen1.5-32b",
              "pixtral-12b", "musicgen-large", "mixtral-8x7b",
              "qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-1.5-large-398b")
B, S = 2, 64


def _batch(cfg, rng, b=B, s=S):
    shape = (b, s, cfg.n_codebooks) if cfg.n_codebooks else (b, s)
    labels = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    labels[:, -5:] = -1                      # masked positions
    out = {"tokens": rng.integers(1, cfg.vocab, shape).astype(np.int32),
           "labels": labels}
    if cfg.frontend == "patch":
        out["patch_embeds"] = rng.normal(
            0, 1, (b, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    return out


def _both(arch, seed, **overrides):
    jc = jcfg.smoke_config(arch, **overrides)
    tc = tcfg.smoke_config(arch, **overrides)
    jp = JT.init_params(jc, jax.random.PRNGKey(seed))
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _assert_tree_close(got, want, tol):
    got, want = flatten(got), flatten(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=tol,
                                   atol=tol, err_msg=k)


# ---------------------------------------------------------------- packing --

@pytest.mark.parametrize("batch,seq", [(8, 256), (2, 64), (3, 7), (64, 128)])
def test_pack_tokens_is_bit_identical(batch, seq):
    for seed in (0, 1):
        jb = JBlockDataset(n_blocks=2, records_per_block=64, max_len=48,
                           vocab=512, seed=seed).block(1)["tokens"]
        tb = BlockDataset(n_blocks=2, records_per_block=64, max_len=48,
                          vocab=512, seed=seed).block(1)["tokens"]
        np.testing.assert_array_equal(tb, jb)
        want, got = j_pack_tokens(jb, batch, seq), pack_tokens(tb, batch, seq)
        assert got.tokens.dtype == want.tokens.dtype == np.int32
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.nonpad_tokens == want.nonpad_tokens
        assert got.shape == want.shape == (batch, seq)


# ---------------------------------------------------------------- loss_fn --

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_fn_value_and_grads_match_reference(arch, remat):
    jc, tc, jp, tp = _both(arch, 4, remat=remat)
    batch = _batch(jc, np.random.default_rng(4))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {k: jnp.asarray(v)
                                     for k, v in batch.items()}),
        has_aux=True)(jp)
    leaves = tree_map(lambda p: p.requires_grad_(), tp)
    tl, tm = TT.loss_fn(leaves, tc, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    for got, want in ((tl, jl), (tm["nll"], jm["nll"]),
                      (tm["aux"], jm["aux"])):
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert (float(tm["aux"]) > 0) == (jc.moe is not None)
    grads = torch.autograd.grad(tl, tree_leaves(leaves))
    want = flatten(jax.tree.map(np.asarray, jg))
    assert list(flatten(leaves)) == list(want)
    for (k, w), g in zip(want.items(), grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6),
                                   err_msg=k)


@pytest.mark.parametrize("micro", [1, 2])
def test_grad_shard_on_plain_tensors_is_unsharded(micro):
    """Gradient sharding acts on DTensors only (``tests/test_torch_parallel.py``
    runs it on a mesh); on plain tensors a config that names it takes the
    unsharded step bit for bit."""
    jc, tc, _, tp = _both("olmo-1b", 6)
    opt = AdamWConfig(lr=1e-3)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(jc, np.random.default_rng(6), b=4, s=32).items()}
    got = make_train_step(tc.replace(grad_shard=("data", 2)), opt,
                          num_microbatches=micro)(tp, adamw_init(tp, opt),
                                                  batch)
    want = make_train_step(tc, opt, num_microbatches=micro)(
        tp, adamw_init(tp, opt), batch)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- train step --

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    jc, tc, jp, tp = _both("olmo-1b", 5)
    jo, to = JAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstep = jax.jit(j_make_train_step(jc, jo, num_microbatches=micro,
                                      lr_fn=j_lr(1e-3, 2, 10)))
    tstep = make_train_step(tc, to, num_microbatches=micro,
                            lr_fn=linear_warmup_cosine(1e-3, 2, 10))
    js, ts = j_adamw_init(jp, jo), adamw_init(tp, to)
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = _batch(jc, rng, b=4, s=32)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    assert int(ts["step"]) == int(js["step"]) == 3
    _assert_tree_close(tp, jp, 1e-5)
    _assert_tree_close(ts["m"], js["m"], 1e-5)


@pytest.mark.parametrize("micro", [1, 2])
def test_mamba_train_step_matches_reference(micro):
    """Smoke mamba2-1.3b, its SSD differentiated through the ``ssd_scan``
    autograd Function: three steps against the reference's, at the olmo
    step's tolerances."""
    jc, tc, jp, tp = _both("mamba2-1.3b", 8)
    jo, to = JAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstep = jax.jit(j_make_train_step(jc, jo, num_microbatches=micro))
    tstep = make_train_step(tc, to, num_microbatches=micro)
    js, ts = j_adamw_init(jp, jo), adamw_init(tp, to)
    rng = np.random.default_rng(8)
    for _ in range(3):
        batch = _batch(jc, rng, b=4, s=32)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    _assert_tree_close(tp, jp, 1e-5)
    _assert_tree_close(ts["v"], js["v"], 1e-5)


# ---------------------------------------------------------------- trainer --

def _tc(kind, tmp_path, **kw):
    """The reference test's ``_mk_trainer`` settings."""
    defaults = dict(batch=2, seq_len=64, total_steps=12, ckpt_every=4,
                    warmup=2, ckpt_dir=str(tmp_path / "ck"), seed=3,
                    dvfs_enabled=False)
    defaults.update(kw)
    return kind(**defaults)


def _mk_trainer(tmp_path, **kw):
    cfg = tcfg.smoke_config("olmo-1b")
    ds = BlockDataset(n_blocks=4, records_per_block=64, max_len=48,
                      vocab=cfg.vocab, seed=1)
    return Trainer(cfg, _tc(TrainConfig, tmp_path, **kw), dataset=ds,
                   device="cpu")


def test_trainer_matches_reference_from_its_checkpoint(tmp_path):
    """The reference writes its step-0 {"params", "opt"} checkpoint; both
    trainers resume from it and train 12 steps."""
    jc = jcfg.smoke_config("olmo-1b")
    jp = JT.init_params(jc, jax.random.PRNGKey(7))
    j_save_checkpoint(str(tmp_path / "j" / "ck" / "step_0000000000"),
                      {"params": jp,
                       "opt": j_adamw_init(jp, JAdamWConfig(
                           lr=3e-4, moment_dtype=jc.opt_dtype))}, step=0)
    shutil.copytree(tmp_path / "j" / "ck", tmp_path / "t" / "ck")
    ds = JBlockDataset(n_blocks=4, records_per_block=64, max_len=48,
                       vocab=jc.vocab, seed=1)
    want = JTrainer(jc, _tc(JTrainConfig, tmp_path / "j"),
                    dataset=ds).run(resume=True)
    got = _mk_trainer(tmp_path / "t").run(resume=True)
    assert [h["step"] for h in got["history"]] == \
        [h["step"] for h in want["history"]] == list(range(12))
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]],
                               rtol=1e-5)
    _assert_tree_close(got["params"], want["params"], 1e-5)


def test_trainer_loss_decreases(tmp_path):
    res = _mk_trainer(tmp_path, total_steps=25).run(resume=False)
    assert np.isfinite(res["final_loss"])
    assert res["final_loss"] < res["first_loss"]


def test_trainer_failure_recovery_is_bitexact(tmp_path):
    """Crash at step 9, restore from ckpt at 8 -> same params as a clean
    run."""
    clean = _mk_trainer(tmp_path / "a").run(resume=False)
    faulty = _mk_trainer(tmp_path / "b").run(resume=False,
                                             inject_failure_at=9)
    assert [h["step"] for h in faulty["history"]] == \
        list(range(9)) + list(range(8, 12))
    for a, b in zip(tree_leaves(clean["params"]),
                    tree_leaves(faulty["params"])):
        assert torch.equal(a, b)


def test_trainer_drops_the_restored_trees(tmp_path):
    """After a restore the first step takes the restored weights and
    moments; from the second on none of them is alive (at olmo-1b, a
    lingering copy is 15.4 GB of device memory)."""
    tr = _mk_trainer(tmp_path)
    refs, alive = [], []
    restore, step_fn = tr.ckpt.restore_latest, tr._step_fn

    def spy_restore(like, **kw):
        out = restore(like, **kw)
        refs.extend(weakref.ref(t) for t in tree_leaves(out[0]))
        return out

    def spy_step(*args):
        if refs:
            alive.append(sum(r() is not None for r in refs))
        return step_fn(*args)

    tr.ckpt.restore_latest, tr._step_fn = spy_restore, spy_step
    tr.run(resume=False, inject_failure_at=9)
    assert len(alive) == 4 and alive[0] == len(refs) > 0
    assert alive[1:] == [0, 0, 0]


def test_trainer_dvfs_saves_energy(tmp_path):
    res = _mk_trainer(tmp_path, dvfs_enabled=True, total_steps=16,
                      deadline_slack=1.3).run(resume=False)
    # the DVFS ledger uses simulated frequencies; busy energy must not exceed
    # the DVO (f_max) counterfactual
    assert res["energy"]["busy_j"] <= res["energy_dvo"]["busy_j"] * 1.001
    freqs = {h["rel_freq"] for h in res["history"]}
    assert any(f < 1.0 for f in freqs)  # it actually down-clocked something


def test_calibration_leaves_the_weights_as_they_were(tmp_path):
    tr = _mk_trainer(tmp_path, dvfs_enabled=True)
    params, opt = tr._init_state()
    before = {k: v.clone() for k, v in flatten({"p": params,
                                                "o": opt}).items()}
    blocks = tr._calibrate_and_plan(params, opt)
    assert len(blocks) == tr.dataset.n_blocks and tr.controller.plan
    after = flatten({"p": params, "o": opt})
    assert all(torch.equal(before[k], v) for k, v in after.items())


def test_launch_train_runs_on_the_cpu_and_refuses_a_missing_card(
        tmp_path, capsys, monkeypatch):
    args = ["--arch", "olmo-1b", "--preset", "smoke", "--steps", "10",
            "--ckpt-dir", str(tmp_path / "ck")]
    launch_train.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "-> " in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(args)
