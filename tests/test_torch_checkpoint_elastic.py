"""Elastic restarts across the two packages, on the CPU.

The settings of ``tests/test_checkpoint_elastic.py``: reduced Mixtral-8x22B
(8 experts) in fp32, dropless, ``deterministic_router``,
``aux_loss_coef=0``, ``grad_clip=0``, the fp32 master in the AdamW state;
6 steps of ``SyntheticTokens`` of 32 tokens a sequence, a checkpoint after
3.

* The port (2 layers, 2 sequences a step) trains 3 steps in a gloo world
  of 8 at attention (2, 2, 2) / MoE (1, 4, 2) and saves (``block=False``,
  committed during step 4). JAX's ``restore_train_state`` onto attention
  (4, 1, 2) / MoE (2, 2, 2) equals every rank's pieces bit for bit. A
  world of 4 restores the same step at attention (2, 1, 2) / MoE (2, 2, 1)
  (shrink) and continues 3 steps within 1e-6 (absolute, loss) of the world
  of 8's uninterrupted run.
* JAX (4 layers, 4 sequences a step) trains 3 steps at attention
  (2, 2, 2) / MoE (1, 4, 2) and saves. A world of 4 restores it at
  attention (2, 1, 2) / MoE (2, 2, 1) and at PP2 × vpp 2 over attention
  (2, 1, 1) / MoE (1, 2, 1): each rank's tensors equal its slices from
  ``convert.tensors_from_jax`` / ``opt_state_from_jax`` bit for bit, and 3
  more steps are within 1e-4 (relative, loss and ``grad_norm``) of JAX's.

Where the sequence is cut (cp · tp > 1) a DP rank takes one sequence a
microbatch: the port runs JAX's 4 sequences as 2 microbatches there and at
the pipelined fold (the same mean over the same tokens as JAX's one batch).

JAX is imported inside the test functions only: the world's processes
import this module to find their workers.
"""
import concurrent.futures
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs.base import ParallelConfig, ParallelMappingSpec as PM

STEPS, CUT, SEQ = 6, 3, 32
PORT, JAX = dict(layers=2, batch=2), dict(layers=4, batch=4)     # the two writers' runs
OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=STEPS, grad_clip=0.0, master_weights=True)
ATOL = 1e-6                 # the port against itself across worlds (loss)
REL = 1e-4                  # the port against JAX
# name: (attn, moe, pp, vpp); microbatches: the run's batch over DP ranks
FOLDS = {"saving-8": ((2, 2, 2), (1, 4, 2), 1, 1),
         "shrink-4": ((2, 1, 2), (2, 2, 1), 1, 1),
         "pipe-4": ((2, 1, 1), (1, 2, 1), 2, 2)}


def _pcfg(fold, run):
    attn, moe, pp, vpp = FOLDS[fold]
    return ParallelConfig(attn=PM(*attn), moe=PM(*moe), pp=pp, vpp=vpp,
                          microbatch=run["batch"] // attn[0] if run["batch"] > attn[0] else 0)


def _cfg(run):
    from repro_torch.launch.train import train_config
    cfg = train_config("mixtral-8x22b", layers=run["layers"], reduce=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=True, n_experts=8, deterministic_router=True, aux_loss_coef=0.0))


def _opt():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(**OPT)


def _batches(start, stop, fg, run):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, shard_batch
    data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=run["batch"],
                                      vocab_size=_cfg(run).vocab_size)).seek(start)
    return [{k: torch.from_numpy(v) for k, v in
             shard_batch(next(data), fg, microbatch=fg.pcfg.microbatch).items()}
            for _ in range(start, stop)]


def _run(params, opt, fg, start, stop, run):
    from repro_torch.train.loop import make_train_step
    step = make_train_step(_cfg(run), _opt(), microbatch=fg.pcfg.microbatch, groups=fg)
    losses = []
    for b in _batches(start, stop, fg, run):
        params, opt, m = step(params, opt, b)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return params, opt, losses


def _pieces(params, opt, fg):
    """This rank's state as the checkpoint's pieces, on the host."""
    from repro_torch.train.loop import train_state_tree
    tree = train_state_tree(_cfg(PORT), params, opt, groups=fg)
    return {k: [(box, t.numpy().copy()) for box, t in getattr(v, "pieces", (((), v),))]
            for k, v in tree.items()}


def _port_world8(rank, world, directory):
    from repro_torch.core.folding import build_folded_groups
    from repro_torch.resilience.driver import init_params
    from repro_torch.train.loop import init_train_state, save_train_state
    fg = build_folded_groups(_pcfg("saving-8", PORT), rank=rank, world=world)
    params = init_params(_cfg(PORT), 0, torch.device("cpu"), fg)
    opt = init_train_state(params, _opt(), cfg=_cfg(PORT), groups=fg)
    params, opt, pre = _run(params, opt, fg, 0, CUT, PORT)
    pending = save_train_state(directory, CUT, params, opt, cfg=_cfg(PORT), groups=fg,
                               block=False)
    saved = _pieces(params, opt, fg)
    params, opt, post = _run(params, opt, fg, CUT, CUT + 1, PORT)      # beside the write
    pending.wait()
    params, opt, rest = _run(params, opt, fg, CUT + 1, STEPS, PORT)
    return dict(losses=pre + post + rest, saved=saved)


def _jax_state(path):
    """JAX's params and AdamW state as the test wrote them (numpy, under the
    checkpoint's keys), once the file is there: the world starts while JAX
    still trains."""
    from repro_torch.optim.adamw import AdamWState
    while not os.path.exists(path):
        time.sleep(0.05)

    def nest(prefix):
        tree = {}
        for k in flat:
            if k.startswith(prefix):
                *parents, leaf = k[len(prefix):].split("/")
                node = tree
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = flat[k]
        return tree
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return nest("params/"), AdamWState(flat["opt/.step"], nest("opt/.mu/"), nest("opt/.nu/"),
                                       nest("opt/.master/"))


def _port_world4(rank, world, directory, jax_state_path):
    """Restore ``directory``'s step CUT at the shrink fold (and with
    ``jax_state_path``, once JAX's numpy params and AdamW state are there,
    also at the pipelined fold, each rank's tensors held against its slices
    of them), and run to STEPS."""
    from repro_torch.convert import opt_state_from_jax, tensors_from_jax
    from repro_torch.core.folding import build_folded_groups
    from repro_torch.train.loop import restore_train_state
    jax_state = _jax_state(jax_state_path) if jax_state_path else None
    out, run = {}, JAX if jax_state else PORT
    cfg = _cfg(run)
    for fold in ("shrink-4",) + (("pipe-4",) if jax_state else ()):
        fg = build_folded_groups(_pcfg(fold, run), rank=rank, world=world)
        params, opt = restore_train_state(directory, CUT, cfg, _opt(), groups=fg,
                                          device="cpu", verify=True)
        bad = []
        if jax_state:
            jp, jo = jax_state
            want_p = tensors_from_jax(jp, cfg, device="cpu", groups=fg)
            want_o = opt_state_from_jax(jo, cfg, device="cpu", groups=fg)
            got_p = dict(params.named_parameters())
            bad += [f"params {n}" for n, t in want_p.items()
                    if not (t.dtype == got_p[n].dtype and torch.equal(t, got_p[n]))]
            for what in ("mu", "nu", "master"):
                want, got = getattr(want_o, what), getattr(opt, what)
                assert want.keys() == got.keys()
                bad += [f"{what} {n}" for n, t in want.items() if not torch.equal(t, got[n])]
            if not torch.equal(want_o.step, opt.step):
                bad.append("step")
        params, opt, losses = _run(params, opt, fg, CUT, STEPS, run)
        out[fold] = dict(bad=bad, losses=losses, stage=fg.pp_stage)
    return out


def _jax_cfg(run):
    from repro.configs import get_config, reduced
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x22b")), dtype="float32",
                              n_layers=run["layers"])
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dropless=True, n_experts=8, deterministic_router=True, aux_loss_coef=0.0))


def _jax_fm(attn, moe):
    from repro.configs.base import ParallelConfig as JPC, ParallelMappingSpec as JPM
    from repro.core.folding import build_folded_mesh
    return build_folded_mesh(JPC(attn=JPM(*attn), moe=JPM(*moe)))


def test_port_checkpoint_reads_in_jax_and_resumes_on_a_smaller_world(tmp_path):
    import jax
    from repro.checkpoint import store as jstore
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop
    from repro_torch.launch.world import spawn
    d = str(tmp_path / "ckpt")
    w8 = spawn(_port_world8, 8, backend="gloo", device="cpu", args=(d,), timeout_s=300,
               init_dir=str(tmp_path))
    w4 = spawn(_port_world4, 4, backend="gloo", device="cpu", args=(d, None), timeout_s=300,
               init_dir=str(tmp_path))

    # JAX restores the port's step onto another fold, bit for bit.
    p, o = jloop.restore_train_state(d, CUT, _jax_cfg(PORT), _jax_fm((4, 1, 2), (2, 2, 2)),
                                     jadamw.AdamWConfig(**OPT))
    full = {k: np.asarray(v) for k, v in jstore._flatten({"params": p, "opt": o}).items()}
    assert set(full) == set(w8[0]["saved"])
    for rank, r in enumerate(w8):
        for k, pieces in r["saved"].items():
            for box, t in pieces:
                got = full[k][tuple(slice(a, b) for a, b in box)]
                assert got.dtype == t.dtype and np.array_equal(got, t), (rank, k, box)
    assert int(full["opt/.step"]) == CUT

    # Every rank of either world agrees; the smaller world continues the run.
    ref = w8[0]["losses"]
    assert all(r["losses"] == ref for r in w8)
    for r in w4:
        got = r["shrink-4"]
        assert not got["bad"] and got["losses"] == w4[0]["shrink-4"]["losses"]
        for (loss, _), (want, _) in zip(got["losses"], ref[CUT:]):
            assert abs(loss - want) <= ATOL, (loss, want)
    assert ref[-1][0] < ref[0][0]


def test_jax_checkpoint_resumes_in_the_port_shrunk_and_pipelined(tmp_path):
    import jax
    from repro.data.pipeline import DataConfig, SyntheticTokens
    from repro.optim import adamw as jadamw
    from repro.train import loop as jloop
    from repro.checkpoint import store as jstore
    from repro_torch.launch.world import spawn
    d, state = str(tmp_path / "ckpt"), str(tmp_path / "jax_state.npz")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:     # the world starts meanwhile
        world = pool.submit(spawn, _port_world4, 4, backend="gloo", device="cpu",
                            args=(d, state), timeout_s=300, init_dir=str(tmp_path))
        cfg, fm = _jax_cfg(JAX), _jax_fm((2, 2, 2), (1, 4, 2))
        opt_cfg = jadamw.AdamWConfig(**OPT)
        params, opt = jloop.init_train_state(jax.random.PRNGKey(0), cfg, fm, opt_cfg)
        step = jloop.make_train_step(cfg, fm, opt_cfg, donate=False)
        data = SyntheticTokens(DataConfig(seq_len=SEQ, global_batch=JAX["batch"],
                                          vocab_size=cfg.vocab_size))
        bs = jloop.batch_shardings(cfg, fm)
        metrics = []
        for i in range(STEPS):
            if i == CUT:
                jloop.save_train_state(d, CUT, params, opt)
                flat = jstore._flatten({"params": params, "opt": opt})
                with open(state + ".tmp", "wb") as f:
                    np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
                os.replace(state + ".tmp", state)
            batch = {k: jax.device_put(v, bs[k]) for k, v in next(data).items() if k in bs}
            params, opt, m = step(params, opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        w4 = world.result()
    for rank, r in enumerate(w4):
        for fold in ("shrink-4", "pipe-4"):
            got = r[fold]
            assert not got["bad"], (rank, fold, got["bad"])
            for (loss, gnorm), (jl, jg) in zip(got["losses"], metrics[CUT:]):
                assert abs(loss - jl) <= REL * abs(jl), (fold, loss, jl)
                assert abs(gnorm - jg) <= REL * abs(jg), (fold, gnorm, jg)
    assert {r["pipe-4"]["stage"] for r in w4} == {0, 1}
