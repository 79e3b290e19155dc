"""The port's PolicyNet, model registry and reference-checkpoint import
against the JAX package on the CPU.

Inputs are seeded numpy arrays; the nets are small (3 layers of 16
channels, 9x9, the 25 df planes; a 1- or 2-block ResNet for the import;
the reference's 39 x 128 at 9x9 for where the bf16 error comes from).
Tolerances: fp32 forwards within 1e-5 (log-probabilities and values), BN
running statistics after a training forward within 1e-6; the flax trees'
round trip and the converted state dicts exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as F

from elf_tpu.config import TrainOptions as JTrainOptions
from elf_tpu.models import registry as jregistry
from elf_tpu.models.policy_net import PolicyNet as JPolicyNet
from elf_tpu.models.policy_net import PolicyNetConfig as JPolicyNetConfig
from elf_tpu.models.policy_net import init_policy_net as jinit_policy_net
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.models.resnet import PolicyValueNet as JPolicyValueNet
from elf_tpu.tools import import_torch as jimport
from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.env.go import engine, features
from elf_tpu_torch.models import registry as tregistry
from elf_tpu_torch.models.policy_net import (
    PolicyNet,
    PolicyNetConfig,
    init_policy_net,
    policy_params_from_jax,
    policy_params_to_jax,
)
from elf_tpu_torch.models.resnet import ModelConfig, params_from_jax
from elf_tpu_torch.tools import import_torch as timport

pytestmark = pytest.mark.timeout(300)

SIZE = 9
SMALL = dict(board_size=SIZE, num_planes=25, num_layer=3, dim=16,
             num_future_actions=3, use_bf16=False)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _perturbed(params, stats, seed):
    """The flax trees with every leaf moved off its initial value, so that
    a swapped or mis-laid tensor shows in the forward."""
    rng = np.random.default_rng(seed)

    def move(tree, scale, positive=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = move(v, scale, positive)
            else:
                a = np.asarray(v, np.float32)
                d = rng.normal(scale=scale, size=a.shape).astype(np.float32)
                out[k] = np.abs(a + d) + 0.5 if positive else a + d
        return out

    stats = {k: {"mean": move({"m": v["mean"]}, 0.3)["m"],
                 "var": move({"v": v["var"]}, 0.3, positive=True)["v"]}
             for k, v in stats.items()}
    return move(params, 0.05), stats


def _flax_pair(cfg_kw, seed=0):
    jcfg = JPolicyNetConfig(**cfg_kw)
    params, stats = jinit_policy_net(jcfg, jax.random.PRNGKey(seed))
    params, stats = _perturbed(jax.device_get(params),
                               jax.device_get(stats), seed)
    net = policy_params_from_jax(params, stats, PolicyNetConfig(**cfg_kw),
                                 device="cpu")
    return JPolicyNet(jcfg), params, stats, net


def _planes(B, seed, planes=25, size=SIZE):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, size, size, planes)) < 0.4).astype(np.float32)
    return x * rng.uniform(0.5, 1.5, size=(1, 1, 1, planes)).astype(np.float32)


@pytest.mark.parametrize("variant", [
    {}, {"num_future_actions": 1}, {"bn": False}, {"leaky_relu": False},
])
def test_forward_matches_flax(variant):
    """Inference forward (running statistics) and training forward (batch
    statistics, running ones updated with flax's momentum 0.99)."""
    kw = {**SMALL, **variant}
    model, params, stats, net = _flax_pair(kw)
    x = _planes(6, 1)
    j = model.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    t = net(torch.from_numpy(x))
    T = kw["num_future_actions"]
    assert t.shape == (6, T, SIZE * SIZE + 1) and t.dtype == torch.float32
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5,
                               rtol=0)
    j, mut = model.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), train=True, mutable=["batch_stats"])
    t = net(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=1e-5,
                               rtol=0)
    _, tstats = policy_params_to_jax(net)
    ref = dict(_leaves(jax.device_get(mut["batch_stats"])))
    assert dict(_leaves(tstats)).keys() == ref.keys()
    for k, v in _leaves(tstats):
        np.testing.assert_allclose(v, ref[k], atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def test_round_trip_and_init():
    """policy_params_to_jax(policy_params_from_jax(t)) == t exactly; the
    port's init has flax's tree, shapes, `pass_bias` -6 and BN (0, 1)."""
    _, params, stats, net = _flax_pair(SMALL, seed=3)
    p2, s2 = policy_params_to_jax(net)
    for a, b in ((p2, params), (s2, stats)):
        la, lb = dict(_leaves(a)), dict(_leaves(b))
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].dtype == np.float32
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)

    jp, js = jinit_policy_net(JPolicyNetConfig(**SMALL), jax.random.PRNGKey(0))
    ours = init_policy_net(PolicyNetConfig(**SMALL),
                           torch.Generator().manual_seed(0), device="cpu")
    tp, ts = policy_params_to_jax(ours)
    for a, b in ((tp, jax.device_get(jp)), (ts, jax.device_get(js))):
        la, lb = dict(_leaves(a)), dict(_leaves(b))
        assert la.keys() == lb.keys()
        for k in la:
            assert la[k].shape == lb[k].shape, k
            if not k.endswith("kernel"):
                np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    k = tp["conv1"]["kernel"]          # lecun_normal: variance 1 / fan_in
    assert abs(k.std() * np.sqrt(9 * 16) - 1.0) < 0.1
    out = ours(torch.zeros(2, SIZE, SIZE, 25))
    np.testing.assert_allclose(torch.exp(out).sum(dim=2).detach().numpy(),
                               1.0, atol=1e-5)


def test_bf16_forward_close_to_fp32():
    """bf16 convolutions (fp32 BN and final convolution) against the fp32
    net from the same weights: the same top move on most rows."""
    _, params, stats, net32 = _flax_pair(SMALL, seed=4)
    net16 = policy_params_from_jax(params, stats,
                                   PolicyNetConfig(**{**SMALL,
                                                      "use_bf16": True}),
                                   device="cpu")
    x = torch.from_numpy(_planes(32, 5))
    with torch.no_grad():
        a, b = net32(x), net16(x)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(torch.exp(b).sum(dim=2).detach().numpy(), 1.0,
                               atol=1e-5)
    agree = (a.argmax(dim=2) == b.argmax(dim=2)).float().mean()
    assert agree >= 0.8
    assert float((torch.exp(a) - torch.exp(b)).abs().max()) < 0.1


def _df_positions(B, size, seed):
    """df planes of B positions of random legal play at seeded plies; the
    first two rows are the empty board and the board after one move, whose
    distance planes hold the 1e4 sentinel of a side with no stones."""
    rng = np.random.default_rng(seed)
    plies = rng.integers(2, 50, B)
    plies[:2] = [0, 1]
    core = engine.init_core(B, size, "cpu")
    last = torch.zeros((B, size * size), dtype=torch.int32)
    for p in range(int(plies.max())):
        legal = engine.legal_moves(core, size)[:, :size * size].numpy()
        a = torch.tensor([int(rng.choice(np.flatnonzero(legal[b])))
                          if p < plies[b] else size * size
                          for b in range(B)], dtype=torch.int32)
        live = torch.from_numpy(plies > p)
        moved, _ = engine.step_core(core, a, size)
        core = engine.GoCore(*(
            torch.where(live.view(-1, *([1] * (old.dim() - 1))), new, old)
            for old, new in zip(core, moved)))
        hit = live & (a < size * size)
        last[hit, a[hit].long()] = p + 1
    x = features.extract_df_parts(
        core.stones, core.to_play, core.ko_point,
        (core.ko_age == 0) & (core.ko_point >= 0), core.ply, last,
        torch.zeros(B, dtype=torch.int64), size)
    sentinel = (x[..., 14:16] >= 5000).flatten(1).any(1)
    return x, sentinel


def _top_move_agreement(a, b):
    return float((a.argmax(dim=-1) == b.argmax(dim=-1)).float().mean())


def test_bf16_error_is_local_and_its_growth_is_the_flax_modules():
    """Why a random 39-layer PolicyNet's bf16 forward need not pick its
    fp32 twin's top move, held on df planes of random play (9x9, 128
    channels, T = 3, BN statistics from the batch):
    - each bf16 layer, fed the fp32 activations of the layer before, is
      within 1e-2 (relative, Frobenius) of the fp32 layer, sentinel rows
      included: the error one layer adds is bf16's rounding, not a
      squeezed signal;
    - at 5 layers the bf16 forward picks the fp32 top move on at least
      95 % of the rows, in the port and in the flax module;
    - at 39 layers, on rows without the sentinel and with BN statistics
      from them, the flax module's fp32 forward with its kernels rounded
      to bf16 (fp32 arithmetic) picks the exact forward's top move on at
      most half of the rows: the reference net carries a 2^-9 weight
      perturbation past the top move, so the disagreement is a property
      of the random deep net and not of the port or of the df sentinel;
      the port's fp32 forward from the same rounded kernels picks the
      flax module's top move on at least 95 % of the rows."""
    size, T = 9, 3
    x, sentinel = _df_positions(24, size, seed=0)
    assert int(sentinel.sum()) >= 2 and int((~sentinel).sum()) >= 16

    def pair(layers, calib):
        cfg = PolicyNetConfig(board_size=size, num_layer=layers,
                              num_future_actions=T)
        net16 = init_policy_net(cfg, torch.Generator().manual_seed(11),
                                device="cpu")
        for bn in net16.bns:                # BN statistics of `calib`
            bn.momentum = 1.0
        with torch.no_grad():
            net16(calib, train=True)
        params, stats = policy_params_to_jax(net16)
        net32 = policy_params_from_jax(
            params, stats, PolicyNetConfig(**{**cfg.__dict__,
                                              "use_bf16": False}), "cpu")
        return net16, net32, params, stats

    def flax(params, stats, layers, bf16, xs):
        model = JPolicyNet(JPolicyNetConfig(
            board_size=size, num_layer=layers, num_future_actions=T,
            use_bf16=bf16))
        out = model.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(xs.numpy()))
        return torch.from_numpy(np.array(out))

    net16, net32, params, stats = pair(5, x)
    with torch.no_grad():
        assert _top_move_agreement(net16(x), net32(x)) >= 0.95
    assert _top_move_agreement(flax(params, stats, 5, True, x),
                               flax(params, stats, 5, False, x)) >= 0.95

    net16, net32, _, _ = pair(39, x)
    with torch.no_grad():
        h = x.permute(0, 3, 1, 2)
        for i in range(39):
            y32 = net32.bns[i](F.leaky_relu(net32.convs[i](h), 0.1), False)
            y16 = net16.bns[i](F.leaky_relu(net16.convs[i](h.bfloat16()),
                                            0.1), False).bfloat16().float()
            assert float((y16 - y32).norm() / y32.norm()) < 1e-2, i
            h = y32

    clean = x[~sentinel]
    _, _, params, stats = pair(39, clean)
    rounded = {k: ({**v, "kernel": np.asarray(torch.from_numpy(v["kernel"])
                                              .bfloat16().float())}
                   if k.startswith("conv") else v)
               for k, v in params.items()}
    exact = flax(params, stats, 39, False, clean)
    perturbed = flax(rounded, stats, 39, False, clean)
    assert _top_move_agreement(perturbed, exact) <= 0.5
    port = policy_params_from_jax(
        rounded, stats, PolicyNetConfig(board_size=size, num_layer=39,
                                        num_future_actions=T,
                                        use_bf16=False), "cpu")
    with torch.no_grad():
        assert _top_move_agreement(port(clean), perturbed) >= 0.95


def test_registry_and_make_trainer_match_jax():
    # the port's one family more, KataGo's nested-bottleneck net, has no
    # JAX twin
    assert sorted(tregistry.MODELS) == sorted([*jregistry.MODELS,
                                               "kata_nbt"])
    for name, jfam in jregistry.MODELS.items():
        fam = tregistry.MODELS[name]
        assert fam.model_cls.__name__ == jfam.model_cls.__name__
        assert fam.config_cls.__name__ == jfam.config_cls.__name__
        assert fam.loss_fn.__name__ == jfam.loss_fn.__name__
        assert fam.feature_set == jfam.feature_set
    assert tregistry.MODELS["df_policy"].model_cls is PolicyNet
    assert tregistry.MODELS["df_policy"].config_cls is PolicyNetConfig
    for f in ("board_size", "num_planes", "num_layer", "dim",
              "num_future_actions", "bn", "leaky_relu", "use_bf16"):
        assert getattr(PolicyNetConfig(), f) == getattr(JPolicyNetConfig(), f)
    to, jto = TrainOptions(num_block=1, dim=8), JTrainOptions(num_block=1,
                                                              dim=8)
    for name in ("df_kl", "df_pred"):
        for df in (False, True):
            trainer, mode, fs = tregistry.make_trainer(name, SIZE, to, df,
                                                       device="cpu")
            jtrainer, jmode, jfs = jregistry.make_trainer(name, SIZE, jto, df)
            assert (mode, fs) == (jmode, jfs)
            assert trainer.cfg.num_planes == jtrainer.cfg.num_planes
    with pytest.raises(ValueError) as jerr:
        jregistry.make_trainer("df_policy", SIZE, jto)
    with pytest.raises(ValueError) as terr:
        tregistry.make_trainer("df_policy", SIZE, to, device="cpu")
    assert str(terr.value) == str(jerr.value).replace("elf_tpu.",
                                                      "elf_tpu_torch.")


# ------------------------------------------------- reference checkpoints

def _conv_bn_relu(cin, cout, k):
    return tnn.Sequential(tnn.Conv2d(cin, cout, k, padding=k // 2),
                          tnn.BatchNorm2d(cout), tnn.ReLU())


class _RefBlock(tnn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv_lower = _conv_bn_relu(dim, dim, 3)
        self.conv_upper = _conv_bn_relu(dim, dim, 3)

    def forward(self, s):
        return torch.relu(self.conv_upper(self.conv_lower(s)) + s)


class _RefResNet(tnn.Module):
    def __init__(self, dim, num_block):
        super().__init__()
        self.resnet = tnn.Sequential(*[_RefBlock(dim)
                                       for _ in range(num_block)])

    def forward(self, s):
        return self.resnet(s)


class RefPolicyValue(tnn.Module):
    """The reference's `Model_PolicyValue` layout (df_model3.py:183-200),
    NCHW: the module names its state dict holds."""

    def __init__(self, size, planes, dim, num_block):
        super().__init__()
        d = size * size
        self.init_conv = _conv_bn_relu(planes, dim, 3)
        self.resnet = _RefResNet(dim, num_block)
        self.pi_final_conv = _conv_bn_relu(dim, 2, 1)
        self.value_final_conv = _conv_bn_relu(dim, 1, 1)
        self.pi_linear = tnn.Linear(2 * d, d + 1)
        self.value_linear1 = tnn.Linear(d, 256)
        self.value_linear2 = tnn.Linear(256, 1)
        self.d = d

    def forward(self, x):
        s = self.resnet(self.init_conv(x))
        logits = self.pi_linear(self.pi_final_conv(s).reshape(-1, 2 * self.d))
        v = self.value_final_conv(s).reshape(-1, self.d)
        v = torch.tanh(self.value_linear2(torch.relu(self.value_linear1(v))))
        return torch.log_softmax(logits, dim=1), v[:, 0]


@pytest.mark.parametrize("size,blocks,prefix", [(9, 2, False), (5, 1, True)])
def test_import_reference_checkpoint(tmp_path, size, blocks, prefix):
    """A reference-shaped module with moved BN statistics, saved with
    torch.save as the reference saves ({"state_dict", "step", "options"},
    optionally under DataParallel's `module.` prefixes): the port's import
    gives the JAX import's trees exactly, and the port's net from them the
    reference module's outputs and the JAX net's within 1e-5."""
    planes, dim = 18, 16
    torch.manual_seed(size)
    ref = RefPolicyValue(size, planes, dim, blocks).eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.normal_(0, 0.3)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    sd = ref.state_dict()
    if prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    path = tmp_path / "save-7.bin"
    torch.save({"state_dict": sd, "step": 7, "options": {"lr": 0.1}},
               str(path))
    cfg = ModelConfig(board_size=size, num_planes=planes, num_block=blocks,
                      dim=dim, use_bf16=False)
    jcfg = JModelConfig(board_size=size, num_planes=planes, num_block=blocks,
                        dim=dim, use_bf16=False)
    params, stats, step = timport.load_torch_checkpoint(str(path), cfg)
    jparams, jstats, jstep = jimport.load_torch_checkpoint(str(path), jcfg)
    assert step == jstep == 7
    for a, b in ((params, jparams), (stats, jstats)):
        la, lb = dict(_leaves(a)), dict(_leaves(b))
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)

    net = params_from_jax(params, stats, cfg, device="cpu")
    x = np.random.default_rng(size).normal(
        size=(3, planes, size, size)).astype(np.float32)
    with torch.no_grad():
        r_logpi, r_v = ref(torch.from_numpy(x))
        t_logpi, t_v = net(torch.from_numpy(x.transpose(0, 2, 3, 1)))
    j_logpi, j_v = JPolicyValueNet(jcfg).apply(
        {"params": jparams, "batch_stats": jstats},
        jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    for ours, theirs in ((t_logpi, r_logpi), (t_v, r_v),
                         (t_logpi, np.asarray(j_logpi)),
                         (t_v, np.asarray(j_v))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   atol=1e-5, rtol=0)

    bare = tmp_path / "bare.bin"
    torch.save(ref.state_dict(), str(bare))
    assert timport.load_torch_checkpoint(str(bare), cfg)[2] == 0
