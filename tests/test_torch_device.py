"""Where the port's entry points run (``utils/device.resolve_device``).

The rule: an explicit ``device`` wins; tensors keep their own device;
host (numpy) inputs with no ``device`` go to the GPU, and where there is
none that raises a ``RuntimeError`` naming ``device="cpu"`` — work never
moves to the CPU on its own.  Each entry point that takes host arrays is
one case: with no GPU it raises on numpy inputs, and with
``device="cpu"`` it returns, bit for bit, what CPU tensors give (the
path the other CPU tests hold against the JAX package).
"""

import numpy as np
import pytest
import torch

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.utils.device import resolve_device
from flowonthego_tpu_torch.utils.synth import synthetic_frames

torch.set_num_threads(1)

H, W = 32, 64
CFG = port.DISConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=4)
SHIFT = (-2, 0)


def _frames(as_tensor):
    frames = synthetic_frames(21, 2, H, W, SHIFT, factor=4)
    return [torch.as_tensor(f) for f in frames] if as_tensor else list(frames)


def _pair(fn):
    return lambda frames, **kw: fn(frames[0], frames[1], **kw)


def _batch(frames, **kw):
    stack = torch.stack if isinstance(frames[0], torch.Tensor) else np.stack
    return port.batched_flow(stack(frames[:1]), stack(frames[1:]), CFG, **kw)


ENTRY_POINTS = {
    "compute_flow": _pair(lambda a, b, **kw: port.compute_flow(a, b, CFG,
                                                               **kw)),
    "compute_flow_timed": _pair(lambda a, b, **kw: port.compute_flow_timed(
        a, b, CFG, printer=lambda s: None, **kw)),
    "DISFlow.calc": _pair(lambda a, b, **kw: port.DISFlow(CFG, **kw).calc(
        a, b)),
    "stream_flow": lambda frames, **kw: np.stack(list(port.stream_flow(
        frames, CFG, **kw))),
    "batched_flow": _batch,
    "compute_disparity": _pair(lambda a, b, **kw: port.compute_disparity(
        a, b, CFG, **kw)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_device_default(monkeypatch, name):
    run = ENTRY_POINTS[name]
    # no GPU: numpy inputs and no device raise, naming the way to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run(_frames(as_tensor=False))
    # asked for the CPU, or given CPU tensors: the same result, on the CPU
    asked = run(_frames(as_tensor=False), device="cpu")
    given = run(_frames(as_tensor=True))
    for out in (asked, given):
        if isinstance(out, torch.Tensor):
            assert out.device.type == "cpu"
    asked, given = np.asarray(asked), np.asarray(given)
    assert np.isfinite(asked).all()
    np.testing.assert_array_equal(asked, given)
    # and it is the flow: the median finds the known motion (full
    # resolution for every entry point here; disparity is its x part)
    flow = asked.reshape((-1,) + asked.shape[-3:]) if asked.shape[-1] == 2 \
        else asked[None, ..., None]
    med = np.median(flow[0, 8:-8, 8:-8].reshape(-1, flow.shape[-1]), axis=0)
    np.testing.assert_allclose(med, SHIFT[:flow.shape[-1]], atol=0.25)


def test_resolve_device_rules(monkeypatch):
    cpu = torch.zeros(1)
    meta = torch.zeros(1, device="meta")
    host = np.zeros(1)
    assert resolve_device("cpu", meta) == torch.device("cpu")
    assert resolve_device(torch.device("meta"), cpu).type == "meta"
    assert resolve_device(None, cpu, host).type == "cpu"
    assert resolve_device(None, host, meta).type == "meta"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None, host, [1.0]) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None, host)
