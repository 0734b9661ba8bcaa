"""Crash-safe checkpoints and bitwise resume in the port, held against the
JAX package on the CPU.

The manager's files and manifest are the JAX manager's, byte for byte
apart from the save times: the same saves, rotation to ``keep_last``,
``keep_every`` pins, ``pin`` / ``unpin`` and the anchor give the same
directory. A run interrupted by a listener that raises (at the first
``iteration_done`` past iteration 13, in epoch 2) resumes with
``fit(iterator, epochs=2, resume_from=dir)``: in the port from its own
directory to the bits of its uninterrupted run, and from a directory the
JAX package's ``fit`` wrote to within tolerance of the JAX package's
uninterrupted run (parameters 2e-6 absolute, scores 1e-6 relative, as
tests/test_torch_training.py). The nets and streams are
tests/test_torch_fit_stream.py's (2 x LSTM(16), 8 batches an epoch in
chunks of 3, a shuffling iterator).
"""

import json
import os

import pytest
import torch

from deeplearning4j_tpu.resilience import checkpoint as jckpt

from deeplearning4j_tpu_torch import latest_checkpoint
from deeplearning4j_tpu_torch.resilience import checkpoint as ckpt
from deeplearning4j_tpu_torch.resilience import CheckpointListener
from deeplearning4j_tpu_torch.optimize import \
    CheckpointListener as ParityCheckpointListener
from deeplearning4j_tpu_torch.util import model_serializer

from test_torch_fit_stream import _flat, _graph_params_close, _iters, _pair
from test_torch_training import _batch, _params_close

STOP_AFTER = 13


class Interrupt(RuntimeError):
    pass


class Crash:
    """Raises at the first iteration_done past ``STOP_AFTER`` in epoch 2
    (epoch index 1)."""

    def iteration_done(self, model, iteration, epoch):
        if epoch == 1 and iteration > STOP_AFTER:
            raise Interrupt(iteration)

    def on_epoch_end(self, model):
        pass


def _manifest(d):
    doc = json.loads((d / jckpt.MANIFEST_NAME).read_text())
    for e in doc["checkpoints"]:
        e.pop("saved_at")
    return doc


def _files(d):
    return sorted(os.listdir(d))


def test_manager_rotation_pins_and_anchor_match_jax(tmp_path):
    jnet, net = _pair("mln")
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jm = jckpt.CheckpointManager(jd, keep_last=2, keep_every=3)
    pm = ckpt.CheckpointManager(pd, keep_last=2, keep_every=3)
    for it in (2, 4, 6, 8, 10, 12, 14):
        for n, m in ((jnet, jm), (net, pm)):
            n.iteration, n.epoch, n._epoch_batch = it, it // 8, it % 8
            m.save(n)
        if it == 8:
            jm.pin(6), pm.pin(6)
        if it == 10:
            jm.set_anchor(10), pm.set_anchor(10)
        if it == 12:
            jm.unpin(6), pm.unpin(6)
            jm.set_anchor(12), pm.set_anchor(12)
    assert _files(pd) == _files(jd)
    assert _manifest(pd) == _manifest(jd)
    assert pm.anchor == jm.anchor == 12
    assert [c.filename for c in pm.checkpoints()] == \
        [c.filename for c in jm.checkpoints()]
    # each package reads the other's directory
    assert os.path.basename(latest_checkpoint(jd)) == \
        os.path.basename(jckpt.latest_checkpoint(pd)) == \
        ckpt.checkpoint_filename(14, 1)
    reopened = ckpt.CheckpointManager(jd, keep_last=2)
    assert reopened.anchor == 12 and reopened.latest() == jm.latest()
    with pytest.raises(ValueError, match="no checkpoint at iteration 3"):
        pm.pin(3)
    # no companion artifact yet; once the latest has one, both managers
    # return it (the AOT artifact is exec/aot.py's companion_path)
    assert pm.latest_aot() is None and jm.latest_aot() is None
    for m in (jm, pm):
        open(m.latest()[:-len(".zip")] + ".aot.zip", "wb").close()
    assert os.path.basename(pm.latest_aot()) == \
        os.path.basename(jm.latest_aot()) == \
        ckpt.checkpoint_filename(14, 1)[:-len(".zip")] + ".aot.zip"
    # a normalizer saved with a checkpoint reads back in both packages
    from deeplearning4j_tpu.util.model_serializer import \
        restore_normalizer as jax_restore_normalizer
    from deeplearning4j_tpu_torch.data.normalizers import \
        ImagePreProcessingScaler
    path = pm.save(net, normalizer=ImagePreProcessingScaler(0.0, 2.0))
    for norm in (model_serializer.restore_normalizer(path),
                 jax_restore_normalizer(path)):
        assert norm.to_dict() == ImagePreProcessingScaler(0.0, 2.0).to_dict()


def test_manager_recovers_from_a_scan_as_jax(tmp_path):
    """No manifest (or a damaged one): the zips are the truth."""
    _, net = _pair("mln")
    m = ckpt.CheckpointManager(tmp_path, keep_last=5)
    for it in (3, 7):
        net.iteration = it
        m.save(net)
    (tmp_path / ckpt.MANIFEST_NAME).write_text("{torn")
    for mgr in (ckpt.CheckpointManager(tmp_path),
                jckpt.CheckpointManager(tmp_path)):
        assert [c.iteration for c in mgr.checkpoints()] == [3, 7]
    assert latest_checkpoint(tmp_path / "missing") is None


def _run(net, it, d, crash=False, resume=False):
    """Two epochs of ``it``: saving into ``d`` every 2 iterations (keep
    2: the saves at 6 and 8 rotate out before the crash at 14), or
    resuming from it; False when the crash listener stopped it."""
    if crash:
        net.set_listeners(Crash())
    if resume:
        kw = {"resume_from": d}
    else:
        kw = {"checkpoint": CheckpointListener(d, every_n_iterations=2,
                                               keep_last=2)}
    try:
        net.fit(it, epochs=2, **kw)
    except Interrupt:
        return False
    return True


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_port_resume_is_bitwise_its_uninterrupted_run(container, tmp_path):
    _, whole = _pair(container)
    _run(whole, _iters()[1], tmp_path / "whole")
    _, crashed = _pair(container)
    assert not _run(crashed, _iters()[1], tmp_path / "run", crash=True)
    assert crashed.epoch == 1 and crashed.iteration > STOP_AFTER
    names = _files(tmp_path / "run")
    assert len([n for n in names if n.endswith(".zip")]) == 2
    _, fresh = _pair(container)
    assert _run(fresh, _iters()[1], tmp_path / "run", resume=True)
    assert fresh.iteration == whole.iteration == 16 and fresh.epoch == 2
    assert all(torch.equal(a, b) for a, b in zip(_flat(fresh), _flat(whole)))
    opt = fresh.opt_state.items() if container == "graph" \
        else enumerate(fresh.opt_state)
    wopt = whole.opt_state.items() if container == "graph" \
        else enumerate(whole.opt_state)
    for (_, a), (_, b) in zip(opt, wopt):
        assert all(torch.equal(a[k], b[k]) for k in a)
    # what the JAX package would resume from
    assert jckpt.latest_checkpoint(tmp_path / "run") == \
        latest_checkpoint(tmp_path / "run")


@pytest.mark.parametrize("container", ["mln", "graph"])
def test_a_jax_directory_resumes_in_the_port(container, tmp_path):
    """The JAX package's interrupted fit writes the directory; the port
    resumes from it and ends where the JAX package's uninterrupted run
    ends."""
    jwhole, _ = _pair(container)
    jwhole.fit(_iters()[0], epochs=2)
    jnet, net = _pair(container)
    jnet.set_listeners(Crash())
    with pytest.raises(Interrupt):
        jnet.fit(_iters()[0], epochs=2, checkpoint=jckpt.CheckpointListener(
            tmp_path, every_n_iterations=2, keep_last=2))
    assert _run(net, _iters()[1], tmp_path, resume=True)
    meta = model_serializer.read_meta(latest_checkpoint(tmp_path))
    assert (meta["kind"], meta["epoch"]) == (type(net).__name__, 1)
    assert net.iteration == jwhole.iteration == 16
    if container == "graph":
        _graph_params_close(jwhole, net)
    else:
        _params_close(jwhole, net)


def test_checkpoint_argument_forms_and_refusals(tmp_path):
    """A directory saves once an epoch; the parity listener is the same
    listener; resume_from needs an iterator, as in JAX."""
    _, net = _pair("mln")
    net.fit(_iters()[1], epochs=2, checkpoint=tmp_path / "epochs")
    assert _files(tmp_path / "epochs") == [
        ckpt.checkpoint_filename(8, 1), ckpt.checkpoint_filename(16, 2),
        ckpt.MANIFEST_NAME]
    assert net.listeners == []
    parity = ParityCheckpointListener(str(tmp_path / "p"),
                                      every_n_iterations=3)
    net.fit(_iters()[1], checkpoint=None)
    net.set_listeners(parity)
    net.fit(_iters()[1])      # calls at 27 (the cadence's anchor), 30, 32
    assert parity.last_saved_path.endswith(ckpt.checkpoint_filename(30, 3))
    x, y = _batch(0)
    with pytest.raises(ValueError, match="resettable iterator data"):
        net.fit(x, y, resume_from=tmp_path / "epochs")
    with pytest.raises(ValueError, match="resettable iterator"):
        net.fit(iter([]), resume_from=tmp_path / "epochs")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        net.fit(_iters()[1], resume_from=tmp_path / "empty")
    with pytest.raises(ValueError, match="every_n_iterations"):
        CheckpointListener(tmp_path)


def test_restore_into_copies_in_place_and_the_next_step_follows(tmp_path):
    """restore_into keeps every tensor (the fused update's views, which a
    captured graph reads by address) and the host counts follow the zip:
    the next step equals the step of a network loaded from the zip."""
    _, net = _pair("mln")
    x, y = _batch(1)
    for _ in range(3):
        net.fit(x, y)
    path = tmp_path / "c.zip"
    net.save(path)
    _, target = _pair("mln")
    target.fit(x, y)
    ptrs = [t.data_ptr() for p in target.params for t in p.values()]
    model_serializer.restore_into(target, path)
    assert ptrs == [t.data_ptr() for p in target.params for t in p.values()]
    assert int(target.opt_state[0]["0/.count"]) == 3
    assert target.iteration == 3
    loaded = type(net).load(path, device="cpu")
    x2, y2 = _batch(2)
    target.fit(x2, y2)
    loaded.fit(x2, y2)
    assert all(torch.equal(a, b)
               for a, b in zip(_flat(target), _flat(loaded)))
    assert model_serializer.read_meta(path)["iteration"] == 3
    _, graph = _pair("graph")
    with pytest.raises(ValueError, match="Expected ComputationGraph"):
        model_serializer.restore_into(graph, path)


def test_write_model_fsyncs_the_directory(tmp_path, monkeypatch):
    """After the rename, the directory itself is fsynced (a crash right
    after a save keeps the rename resume_from reads)."""
    _, net = _pair("mln")
    opened, synced = {}, []
    real_open = os.open

    def spy_open(path, flags, *a):
        fd = real_open(path, flags, *a)
        opened[fd] = os.fspath(path)
        return fd
    monkeypatch.setattr(os, "open", spy_open)
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(
        opened.get(fd, "file")))
    model_serializer.write_model(net, tmp_path / "m.zip")
    assert synced == ["file", os.fspath(tmp_path)]
    assert _files(tmp_path) == ["m.zip"]
