"""The logits' padded vocab blocks (``models/common.py`` ``vocab_blocks``)
over 4 gloo processes on the CPU, a (1, 4) ('data', 'model') mesh.

Where the vocab V does not tile the model axis, each process holds
ceil(V / 4) columns of the logits, the columns past V padding, while the
head stays whole on every process (``sanitize_pspec``). Each case is held
against the unsplit computation (no mesh) on the same seeded inputs:

* ``all_padding``: V 6 over 4, blocks of 2, the last one all padding,
  tied and untied heads: the loss, the logits gathered whole and the
  gradients of the head and of the input finite and within 1e-6.
* ``negative``: V 10 over 4 (the last block one real column, two of
  padding) with every real logit negative: ``vocab_whole`` gives exactly
  V columns, and their argmax and top-2 gap (``kernels.top2gap``) equal
  the unsplit ones, so no zero of the padding wins.
* ``tiles``: V 8 over 4, the head split into the table's blocks
  (``sharding.local_params``): the logits, the loss, the gathered logits
  and the gradients bit-equal to the split as it was before padded
  blocks (written out in ``_split_before``).

The processes run once for all cases (module fixture); each writes its
results and the test reads them case by case.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMEOUT = 240
B, S, D = 2, 3, 5
CASES = ("all_padding_tied", "all_padding_untied", "negative", "tiles")


def _inputs(vocab, negative=False):
    rng = np.random.default_rng(vocab)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((vocab, D)).astype(np.float32)
    if negative:     # every logit below zero, the padding's value
        x, w = np.abs(x) + 0.1, -np.abs(w) - 0.1
    labels = rng.integers(0, vocab, (B, S)).astype(np.int64)
    labels[0, 0] = -1
    return x, w, labels


def _head(w, tie):
    return {"embedding": w} if tie else {"lm_head": w.T.contiguous()}


def _run(case_x, w, labels, tie, vocab, ctx):
    """(logits block, loss, whole logits, d head, d x) of the head and the
    loss under ``ctx``."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import use_context
    from repro_torch.models import common
    x = torch.from_numpy(case_x).requires_grad_(True)
    w = torch.from_numpy(w).requires_grad_(True)
    with use_context(ctx):
        p = sh.local_params({"embed": _head(w, tie)})["embed"]
        logits = common.lm_logits(p, x, tie, vocab)
        loss = common.cross_entropy_loss(logits, torch.from_numpy(labels),
                                         vocab=vocab)
        loss.backward()
        whole = common.vocab_whole(logits.detach(), vocab)
    return (logits.detach(), loss.detach(), whole, w.grad, x.grad)


def _split_before(case_x, w, labels, ctx):
    """The split as it was while only a vocab that tiles the model axis was
    split: the table's block, its logits whole in width, the model-axis
    sums of the logsumexp and of the gold logit."""
    import torch
    from repro_torch.distributed import compat
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.context import use_context
    from repro_torch.models import common
    x = torch.from_numpy(case_x).requires_grad_(True)
    w = torch.from_numpy(w).requires_grad_(True)
    lab = torch.from_numpy(labels)
    with use_context(ctx):
        blk = sh.local_params({"embed": {"embedding": w}})["embed"][
            "embedding"]
        n = compat.axis_size("model")
        lo = compat.axis_index("model") * blk.shape[0]
        logits = (compat.copy_to(x, "model") @ blk.T).float()
        top = compat.pmax(logits.detach().amax(dim=-1), "model")
        logz = top + torch.log(compat.reduce_from(
            torch.exp(logits - top[..., None]).sum(dim=-1), "model"))
        ids = lab - lo
        mine = (ids >= 0) & (ids < logits.shape[-1])
        picked = torch.gather(logits, -1, torch.where(
            mine, ids, torch.zeros_like(ids))[..., None])[..., 0]
        gold = compat.reduce_from(picked * mine.float(), "model")
        mask = (lab != -1).float()
        loss = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(),
                                                          min=1.0)
        loss.backward()
        whole = common.tp_whole(logits.detach(), n, split_after=False)
    return (logits.detach(), loss.detach(), whole, w.grad, x.grad)


def _rank_main(rank, store, out_dir):
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.top2gap import argmax_gap
    from repro_torch.launch.mesh import context_for_mesh, make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        ctx = context_for_mesh(make_mesh((1, WORLD), ("data", "model"),
                                         device_type="cpu"))
        res = {}
        for case in CASES:
            vocab = {"negative": 10, "tiles": 8}.get(case, 6)
            tie = case != "all_padding_untied"
            x, w, labels = _inputs(vocab, negative=case == "negative")
            split = _run(x, w, labels, tie, vocab, ctx)
            want = (_split_before(x, w, labels, ctx) if case == "tiles"
                    else _run(x, w, labels, tie, vocab, None))
            for name, a, b in zip(("logits", "loss", "whole", "dw", "dx"),
                                  split, want):
                res[f"{case}_{name}"] = a.numpy()
                res[f"{case}_{name}_want"] = b.numpy()
            with torch.no_grad():
                for tag, logits in (("", split[2]), ("_want", want[2])):
                    pred, gap = argmax_gap(logits.reshape(-1, vocab))
                    res[f"{case}_pred{tag}"] = pred.numpy()
                    res[f"{case}_gap{tag}"] = gap.numpy()
        np.savez(os.path.join(out_dir, f"rank_{rank}.npz"), **res)
    finally:
        dist.barrier()
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab_blocks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp / "store"), str(tmp)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [np.load(str(tmp / f"rank_{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("case", CASES)
def test_padded_vocab_blocks_against_the_unsplit_computation(ranks, case):
    vocab = {"negative": 10, "tiles": 8}.get(case, 6)
    n_block = -(-vocab // WORLD)
    for r, got in enumerate(ranks):
        assert got[f"{case}_logits"].shape == (B, S, n_block)
        assert got[f"{case}_whole"].shape == (B, S, vocab)
        for name in ("logits", "loss", "whole", "dw", "dx"):
            a, b = got[f"{case}_{name}"], got[f"{case}_{name}_want"]
            assert np.isfinite(a).all(), (r, name)
            if case == "tiles":
                np.testing.assert_array_equal(a, b, err_msg=f"{r} {name}")
            elif name != "logits":
                np.testing.assert_allclose(a, b, atol=1e-6, rtol=0,
                                           err_msg=f"{r} {name}")
        np.testing.assert_array_equal(got[f"{case}_pred"],
                                      got[f"{case}_pred_want"])
        np.testing.assert_allclose(got[f"{case}_gap"],
                                   got[f"{case}_gap_want"], atol=1e-6,
                                   rtol=0)
        lo = r * n_block
        real = max(0, min(vocab - lo, n_block))
        if case != "tiles":
            # the real columns are the unsplit logits', the padding zeros
            np.testing.assert_allclose(
                got[f"{case}_logits"][..., :real],
                got[f"{case}_whole_want"][..., lo:lo + real], atol=1e-6,
                rtol=0)
            assert not got[f"{case}_logits"][..., real:].any()
    if case == "negative":
        assert (ranks[0]["negative_whole"] < 0).all()
    if case.startswith("all_padding"):
        assert -(-vocab // WORLD) * (WORLD - 1) == vocab   # rank 3: padding


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
