"""The port's ``Server`` on the CPU against the JAX package's ``Server``.

VGG-16 smoke, buckets 1,4,8, the bursts stream served inline, on the
float, int8 and int5 lanes.  Both packages get the same weights (JAX's
``init_cnn`` carried across by ``from_jax_params``) and the same seeded
request stream.  Checked: request conservation, every executable built
once, bucketed results bit-equal to ``engine.infer`` at N=1, and served
results equal to what the JAX ``Server`` serves: bit for bit on the
integer lanes (and equal to the port's direct forward there), within
rtol = atol = 1e-4 on float (fp32 sums in another order).  Both
servers run the stream on a fake clock (as ``tests/test_serve.py`` does),
so which batches flush depends on the arrival times alone, not on how
long the host takes to serve them.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import CNN_SMOKES as JAX_SMOKES
from repro.data.pipeline import SyntheticRequestStream as JaxStream
from repro.engine import ExecutionPolicy as JaxPolicy
from repro.engine import plan_model as jax_plan_model
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch.configs import CNN_SMOKES
from repro_torch.data.pipeline import SyntheticRequestStream
from repro_torch.engine import ExecutionPolicy, plan_model
from repro_torch.launch.serve_cnn import check_run
from repro_torch.serve import ServeConfig, Server
from repro_torch.weights import from_jax_params

BUCKETS = (1, 4, 8)
N_REQUESTS = 13  # one burst of each bucket size


class FakeClock:
    """Deterministic clock + sleep pair for driving the serve loop.

    A sleep returns one nanosecond late, as a real one does: the inline
    loop sleeps until ``t_submit + max_delay`` and then asks the batcher
    whether ``now - t_submit >= max_delay``, which float rounding can
    deny at exactly that time, and the loop would then spin without the
    clock moving.
    """

    LATE_S = 1e-9

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(dt, 0.0) + self.LATE_S


def _stream(cls, datapath):
    cfg = CNN_SMOKES["vgg16"]
    return cls(hw=cfg.input_hw, channels=cfg.layers[0].M,
               n_classes=cfg.n_classes, n_requests=N_REQUESTS, seed=2,
               process="bursts", burst_sizes=BUCKETS, gap_s=0.03,
               dtype="float32" if datapath == "float" else "uint8")


def _served(datapath):
    """(port server, port metrics, JAX results by request id)."""
    jplan = jax_plan_model(JAX_SMOKES["vgg16"], JaxPolicy())
    jparams = jplan.init(jax.random.PRNGKey(1))
    plan = plan_model(CNN_SMOKES["vgg16"], ExecutionPolicy())
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    jrq = rq = None
    if datapath != "float":
        sample = _stream(JaxStream, datapath).sample_batch(4)
        if datapath == "int5":
            jparams, _ = jplan.quantize_int5(jparams)
            params, _ = plan.quantize_int5(params)
            jrq = jplan.calibrate_requant_int5(jparams, sample)
            rq = plan.calibrate_requant_int5(params, torch.from_numpy(sample))
        else:
            jparams, _ = jplan.quantize(jparams)
            params, _ = plan.quantize(params)
            jrq = jplan.calibrate_requant(jparams, sample)
            rq = plan.calibrate_requant(params, torch.from_numpy(sample))
    conf = dict(buckets=BUCKETS, max_delay_ms=5.0, datapath=datapath)
    jclock = FakeClock()
    jsrv = JaxServer.from_plan(jplan, jparams, JaxServeConfig(**conf),
                               requant=jrq, clock=jclock, sleep=jclock.sleep)
    jmetrics = jsrv.run_stream(_stream(JaxStream, datapath))
    jsrv.close()
    want = {r.rid: r.result for r in jmetrics.requests}
    clock = FakeClock()
    srv = Server.from_plan(plan, params, ServeConfig(**conf), requant=rq,
                           clock=clock, sleep=clock.sleep, device="cpu")
    metrics = srv.run_stream(_stream(SyntheticRequestStream, datapath))
    srv.close()
    direct = None
    if datapath != "float":
        fwd = plan.forward_int5 if datapath == "int5" else plan.forward_int8
        direct = {r.rid: fwd(params, torch.from_numpy(r.payload[None]),
                             requant=rq)[0].numpy()
                  for r in metrics.requests}
    return srv, metrics, want, direct


@pytest.mark.parametrize("datapath", ["float", "int8", "int5"])
def test_port_server_serves_what_the_jax_server_serves(datapath):
    srv, metrics, want, direct = _served(datapath)
    assert check_run(srv, metrics, N_REQUESTS, expect_all_buckets=True) == []
    assert set(srv.engine.compile_counts.values()) == {1}
    assert len(srv.engine.compile_counts) == len(BUCKETS)
    assert [r.status for r in metrics.requests] == ["served"] * N_REQUESTS
    assert sorted(want) == [r.rid for r in metrics.requests]
    for r in metrics.requests:
        # bucketed == unbatched, bit for bit
        np.testing.assert_array_equal(
            r.result, srv.engine.infer(r.payload[None])[0])
        if datapath != "float":
            assert r.result.dtype == np.int32
            np.testing.assert_array_equal(r.result, want[r.rid])
            np.testing.assert_array_equal(r.result, direct[r.rid])
        else:
            np.testing.assert_allclose(r.result, want[r.rid], rtol=1e-4,
                                       atol=1e-4)
    # serving built nothing new
    assert set(srv.engine.compile_counts.values()) == {1}
