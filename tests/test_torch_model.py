"""The port's plans and CNN model paths against the JAX package's, on the
CPU.

Plans are compared field by field at full width (shapes only).  The
VGG-16 and AlexNet smokes carry JAX's ``init_cnn`` weights across with
``from_jax_params``; the JAX side runs its Pallas kernel in interpret mode
for the forward passes.  Float logits within rtol = atol = 1e-4 (fp32
sums in another order); int8 weights, requant pairs and int8 features
bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import CNN_REGISTRY as JAX_CNNS
from repro.configs import CNN_SMOKES as JAX_SMOKES
from repro.data.pipeline import SyntheticRequestStream as JaxStream
from repro.engine import ExecutionPolicy as JaxPolicy
from repro.engine import plan_model as jax_plan_model
from repro_torch.configs import CNN_REGISTRY, CNN_SMOKES
from repro_torch.data.pipeline import SyntheticRequestStream
from repro_torch.engine import ExecutionPolicy, plan_model
from repro_torch.nn.conv import ConvNet, init_cnn
from repro_torch.weights import from_jax_params

PALLAS = JaxPolicy(substrate="pallas")
FIELDS = ("x_hw", "c_in", "k", "c_out", "stride", "padding", "groups",
          "relu", "pool", "has_bias", "requant_kind", "epilogue")


@pytest.mark.parametrize("datapath", ["float", "int8"])
@pytest.mark.parametrize("arch", ["vgg16", "alexnet"])
def test_full_width_plans_match(arch, datapath):
    port = plan_model(CNN_REGISTRY[arch], ExecutionPolicy(),
                      datapath=datapath)
    ref = jax_plan_model(JAX_CNNS[arch], JaxPolicy(), datapath=datapath)
    assert len(port.layers) == len(ref.layers) == len(
        CNN_REGISTRY[arch].layers)
    for a, b in zip(port.layers, ref.layers):
        assert {f: getattr(a, f) for f in FIELDS} == \
            {f: getattr(b, f) for f in FIELDS}
    # the int8 sibling plan is the int8 datapath's plan
    assert [lp.epilogue for lp in port.int8.layers] == \
        [lp.epilogue for lp in ref.int8.layers]


@pytest.mark.parametrize("arch", ["vgg16", "alexnet"])
def test_configs_and_param_shapes_match(arch):
    for port_cfg, jax_cfg in ((CNN_REGISTRY[arch], JAX_CNNS[arch]),
                              (CNN_SMOKES[arch], JAX_SMOKES[arch])):
        assert (port_cfg.name, port_cfg.pool_after, port_cfg.classifier,
                port_cfg.n_classes, port_cfg.input_hw) == \
            (jax_cfg.name, jax_cfg.pool_after, jax_cfg.classifier,
             jax_cfg.n_classes, jax_cfg.input_hw)
        assert [tuple(vars(l).values()) for l in port_cfg.layers] == \
            [tuple(vars(l).values()) for l in jax_cfg.layers]
    cfg = CNN_SMOKES[arch]
    jax_p = jax.eval_shape(
        lambda k: jax_plan_model(JAX_SMOKES[arch]).init(k),
        jax.random.PRNGKey(0))
    port_p = init_cnn(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), jax_p) == \
        {k: [{n: tuple(t.shape) for n, t in d.items()} for d in v]
         for k, v in port_p.items()}


@pytest.fixture(scope="module", params=["vgg16", "alexnet"])
def smoke(request):
    """One smoke arch through both packages, from the same weights and
    the same seeded images."""
    arch = request.param
    jplan = jax_plan_model(JAX_SMOKES[arch], PALLAS)
    joracle = jax_plan_model(JAX_SMOKES[arch], JaxPolicy(substrate="oracle"))
    jparams = joracle.init(jax.random.PRNGKey(3))
    plan = plan_model(CNN_SMOKES[arch], ExecutionPolicy())
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    cfg = CNN_SMOKES[arch]
    kw = dict(hw=cfg.input_hw, channels=cfg.layers[0].M,
              n_classes=cfg.n_classes, seed=5)
    imgs = SyntheticRequestStream(**kw).sample_batch(3)
    u8 = SyntheticRequestStream(dtype="uint8", **kw).sample_batch(3)
    assert np.array_equal(imgs, JaxStream(**kw).sample_batch(3))
    assert np.array_equal(u8, JaxStream(dtype="uint8", **kw).sample_batch(3))
    return dict(arch=arch, jplan=jplan, joracle=joracle, jparams=jparams,
                plan=plan,
                params=params, imgs=imgs, u8=u8)


def test_float_logits_match(smoke):
    want = np.asarray(smoke["jplan"].forward(smoke["jparams"],
                                             smoke["imgs"]))
    got = smoke["plan"].forward(smoke["params"],
                                torch.from_numpy(smoke["imgs"])).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    net = ConvNet(CNN_SMOKES[smoke["arch"]], smoke["params"])
    assert torch.equal(net(torch.from_numpy(smoke["imgs"])),
                       torch.from_numpy(got))


def test_int8_lane_bit_identical(smoke):
    jplan, joracle, plan = smoke["jplan"], smoke["joracle"], smoke["plan"]
    jq, jscales = jplan.quantize(smoke["jparams"])
    q, scales = plan.quantize(smoke["params"])
    for a, b in zip(q["conv"], jq["conv"]):
        assert a["kernel"].dtype == torch.int8
        np.testing.assert_array_equal(a["kernel"].numpy(),
                                      np.asarray(b["kernel"]))
    assert scales == [float(s) for s in jscales]

    u8 = smoke["u8"]
    # calibration on the JAX oracle (exact integers either way); the
    # forward through its Pallas kernel
    jpairs = joracle.calibrate_requant(jq, u8)
    pairs = plan.calibrate_requant(q, torch.from_numpy(u8))
    assert len(pairs) == len(jpairs) == len(plan.layers) - 1
    for (m, s), (jm, js) in zip(pairs, jpairs):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    want = np.asarray(jplan.forward_int8(jq, u8, requant=jpairs))
    got = plan.forward_int8(q, torch.from_numpy(u8), requant=pairs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the dynamic power-of-two path and its calibrated shifts, too
    assert plan.calibrate_requant_shifts(q, torch.from_numpy(u8)) == \
        joracle.calibrate_requant_shifts(jq, u8)


def test_serve_forward_equals_forward_per_image(smoke):
    plan, params = smoke["plan"], smoke["params"]
    imgs = torch.from_numpy(smoke["imgs"])
    batched = plan.serve_forward(params, imgs)
    for i in range(imgs.shape[0]):
        assert torch.equal(batched[i:i + 1],
                           plan.forward(params, imgs[i:i + 1]))
