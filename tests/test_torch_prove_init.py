"""The 19x19 20b256c learning proof's starting point and its pieces on the
CPU: the JAX run's init is the committed export; the port's proof trains
from an init export it is given; one full-width train step from that init
against the JAX step; the proof's eval actor against the JAX script's.

Tolerances: the JAX init against the bf16 export, bf16 rounding (each
value within 2^-8 of its magnitude, a half unit in the last place of
bf16's 8-bit significand, plus 1e-6 of its tensor's largest magnitude:
the export was drawn on another backend, whose truncated normal differs
from the CPU's in the last fp32 bits, so 0.07 % of the values round the
other way).  The one-step parity in float64 (both nets in float64
throughout, one position): the loss and every stat within 1e-12, every
parameter and BN statistic within 1e-10 of the largest magnitude in its
layer, and every tensor's update within 1e-9 of its own largest
magnitude.  In fp32: the loss within 1e-5, every stat within 1e-4, the
whole update's cosine and length within 1e-4 of the JAX update's, and
each parameter and BN statistic within 2e-3 of its layer's largest
magnitude: at this batch a BN backward over 4 x 361 positions of the
random net is ill-conditioned, and single layers' fp32 updates differ
between the packages by up to 8e-4 of their kernel's scale (the test
prints its figures with `-s`), as each package's fp32 step differs from
its float64 step; so 1e-4 of a layer holds in float64, not in fp32."""

import ast
import dataclasses
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from elf_tpu.config import TrainOptions as JTrainOptions
from elf_tpu.models.resnet import ModelConfig as JModelConfig
from elf_tpu.search.mcts import MCTSConfig as JMCTSConfig
from elf_tpu.selfplay.actor import ActorConfig as JActorConfig
from elf_tpu.training.trainer import Trainer as JTrainer
from elf_tpu.training.trainer import load_checkpoint as jload_checkpoint
from elf_tpu_torch.config import TrainOptions
from elf_tpu_torch.models.resnet import ModelConfig, params_to_jax
from elf_tpu_torch.training.trainer import (
    Trainer,
    load_checkpoint,
    save_params_checkpoint,
)
from scripts import prove_learning
from scripts import prove_learning_torch as plt

pytestmark = pytest.mark.timeout(300)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIT = os.path.join(REPO, "runs", "prove19", "init_params.bin")
# the README's 19x19 proof (README.md, "19x19 at the production shape")
PROOF19 = ["--out", "unused", "--board_size", "19", "--blocks", "20",
           "--dim", "256", "--batch_boards", "256", "--rollouts", "64",
           "--train_bs", "256", "--sample_ratio", "1.0",
           "--eval_every_games", "300", "--eval_games", "64",
           "--eval_rollouts", "64", "--value_weight", "0.25"]
TINY = ["--device", "cpu", "--board_size", "5", "--blocks", "1",
        "--dim", "16", "--batch_boards", "4", "--rollouts", "8",
        "--train_bs", "16", "--eval_games", "2", "--eval_rollouts", "0"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's parallel workers would otherwise
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree).astype(np.float64)


def _proof_train_options(args, package):
    """TrainOptions as both proof scripts build them."""
    return package(batchsize=args.train_bs, num_block=args.blocks,
                   dim=args.dim, lr=args.lr, num_cooldown=8,
                   value_loss_weight=args.value_weight)


# ------------------------------------------------------------ the init

def test_jax_seed7_init_is_the_committed_export():
    """What the JAX proof trains from: its LearnerRunner's
    `init_state(PRNGKey(seed))` at the default seed 7 is
    `runs/prove19/init_params.bin` up to bf16 rounding."""
    args = prove_learning.parse_args(PROOF19)
    jtr = JTrainer(JModelConfig(board_size=19, num_planes=18, num_block=20,
                                dim=256, use_bf16=True),
                   _proof_train_options(args, JTrainOptions))
    state = jtr.init_state(jax.random.PRNGKey(args.seed))
    export = jload_checkpoint(INIT)
    assert int(export.step) == 0
    rounded = total = 0
    for tree in ("params", "batch_stats"):
        ours = dict(_leaves(jax.device_get(getattr(state, tree))))
        ref = dict(_leaves(getattr(export, tree)))
        assert ours.keys() == ref.keys() and len(ref) > 80, tree
        for k, want in ref.items():
            got = ours[k]
            assert got.shape == want.shape, k
            bound = np.abs(got) * 2.0 ** -8 + 1e-6 * np.abs(got).max()
            assert (np.abs(got - want) <= bound).all(), k
            rounded += int((got.astype(ml_dtypes.bfloat16)
                            .astype(np.float32) == want).sum())
            total += got.size
    # the draws differ in their last fp32 bits only, so almost every value
    # is the bf16 rounding of the CPU's draw
    assert total > 24_000_000 and rounded / total > 0.999


def _setup_of_main(argv, monkeypatch):
    """Run `prove_learning_torch.main(argv)` up to its first self-play
    move; return (the learner runner, the states `load_checkpoint` gave,
    the net the first move was asked to play)."""

    class Stop(Exception):
        pass

    runners, loaded, played = [], [], []

    class Recording(plt.LearnerRunner):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runners.append(self)

    def recording_load(*a, **k):
        loaded.append(load_checkpoint(*a, **k))
        return loaded[-1]

    def first_move(self, params, batch_stats, n_moves, request=None):
        played.append(params)
        raise Stop

    monkeypatch.setattr(plt, "LearnerRunner", Recording)
    monkeypatch.setattr(plt, "load_checkpoint", recording_load)
    monkeypatch.setattr(plt.SelfplayActor, "play_moves", first_move)
    with pytest.raises(Stop):
        plt.main(argv)
    return runners[0], loaded, played[0]


def test_trainee_starts_from_the_init_export(tmp_path, monkeypatch, capsys):
    """An --out holding only `init_params.bin` (here drawn from another
    seed than the run's) trains from that export: the trainee's parameters
    and BN statistics equal the frozen baseline's exactly, at step 0 with
    zero optimizer slots, and share no storage with it."""
    out = tmp_path / "run"
    out.mkdir()
    tr = Trainer(ModelConfig(board_size=5, num_planes=18, num_block=1,
                             dim=16, use_bf16=True),
                 TrainOptions(batchsize=16, num_block=1, dim=16),
                 device="cpu")
    other = tr.init_state(torch.Generator().manual_seed(123))
    # non-default BN statistics, so they are checked too
    with torch.no_grad():
        for n, b in other.net.named_buffers():
            b.add_(0.5 if n.endswith("running_mean") else 0.25)
    save_params_checkpoint(str(out / "init_params.bin"), other)

    runner, loaded, played = _setup_of_main(TINY + ["--out", str(out)],
                                            monkeypatch)
    state0, trainee = loaded[0], runner.state
    assert played is trainee.net and trainee.net is not state0.net
    assert trainee.step == 0
    ref = {**dict(other.net.named_parameters()),
           **dict(other.net.named_buffers())}
    ours = {**dict(trainee.net.named_parameters()),
            **dict(trainee.net.named_buffers())}
    base = {**dict(state0.net.named_parameters()),
            **dict(state0.net.named_buffers())}
    assert ours.keys() == base.keys() == ref.keys()
    for n, t in ours.items():
        assert torch.equal(t, base[n]), n
        assert t.data_ptr() != base[n].data_ptr(), n
        # the export holds bf16 values of the drawn init
        torch.testing.assert_close(t, ref[n].bfloat16().float(), atol=0,
                                   rtol=0, msg=n)
    slots = [t for t in jax.tree_util.tree_leaves(trainee.opt_state)
             if isinstance(t, torch.Tensor)]
    assert slots and not any(bool(t.any()) for t in slots)
    assert "# trainee = init export" in capsys.readouterr().out


def test_other_resume_branches_are_unchanged(tmp_path, monkeypatch, capsys):
    """A fresh --out still draws the seeded init and trains from it; an
    --out with an export-latest.bin resumes the trainee from that."""
    fresh = tmp_path / "fresh"
    runner, loaded, played = _setup_of_main(TINY + ["--out", str(fresh)],
                                            monkeypatch)
    assert loaded == [] and played is runner.state.net
    assert (fresh / "init.bin").exists()
    assert "# trainee = init export" not in capsys.readouterr().out

    resumed = tmp_path / "resumed"
    resumed.mkdir()
    init = load_checkpoint(str(fresh / "init.bin"), template=runner.state)
    save_params_checkpoint(str(resumed / "init_params.bin"), init)
    later = load_checkpoint(str(fresh / "init.bin"), template=runner.state)
    with torch.no_grad():
        for p in later.net.parameters():
            p.mul_(0.5)
    save_params_checkpoint(str(resumed / "export-latest.bin"), later)
    runner, loaded, played = _setup_of_main(TINY + ["--out", str(resumed)],
                                            monkeypatch)
    assert "# trainee = init export" not in capsys.readouterr().out
    assert len(loaded) == 2 and runner.state is loaded[1]
    for p, q in zip(runner.state.net.parameters(),
                    loaded[0].net.parameters()):
        assert torch.equal(p, q * 0.5)


# ------------------------------------------------- one full-width step

def _float64_everywhere(monkeypatch):
    """Both packages' nets in float64: the JAX modules' float32 becomes
    float64 (with x64 on), the port's compute dtype too, and the port's
    BatchNorm keeps its input's dtype (the same statistics otherwise)."""
    import types

    import jax.numpy as jnp

    import elf_tpu.models.resnet as jresnet
    import elf_tpu.training.loss as jloss
    import elf_tpu.training.trainer as jtrainer
    import elf_tpu_torch.models.resnet as tresnet

    ns = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
    ns.float32 = jnp.float64
    for mod in (jresnet, jloss, jtrainer):
        monkeypatch.setattr(mod, "jnp", ns)

    def batch_norm(self, x):
        mean = x.mean(dim=(0, 2, 3))
        var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp(min=0.0)
        return self._normalise(x, mean, var), mean, var

    monkeypatch.setattr(tresnet.BatchNorm, "batch_norm", batch_norm)
    monkeypatch.setattr(tresnet.ModelConfig, "compute_dtype",
                        property(lambda self: torch.float64))


def _cast_tree(tree, cast):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, cast) for k, v in tree.items()}
    return cast(tree)


@pytest.mark.parametrize("width", ["float32", "float64"])
def test_full_width_step_from_the_init_matches_jax(width, monkeypatch):
    """One train step at 19x19 20b256c from `init_params.bin` with the
    proof's TrainOptions (lr 0.02, value weight 0.25, cooldown 8) on
    seeded positions, in both packages: 4 positions with fp32
    convolutions, 1 with every op in float64."""
    f64 = width == "float64"
    if f64:
        _float64_everywhere(monkeypatch)
        x64 = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
    dt = np.float64 if f64 else np.float32
    try:
        args = prove_learning.parse_args(PROOF19)
        jtr = JTrainer(JModelConfig(board_size=19, num_planes=18,
                                    num_block=20, dim=256, use_bf16=False),
                       _proof_train_options(args, JTrainOptions))
        jstate = jload_checkpoint(
            INIT, template=jtr.init_state(jax.random.PRNGKey(0)))
        jstate = jstate._replace(**{
            k: jax.tree.map(lambda a: np.asarray(a, dt)
                            if np.issubdtype(a.dtype, np.floating) else a,
                            getattr(jstate, k))
            for k in ("params", "batch_stats", "opt_state")})
        ttr = Trainer(ModelConfig(board_size=19, num_planes=18, num_block=20,
                                  dim=256, use_bf16=False),
                      _proof_train_options(plt.parse_args(PROOF19),
                                           TrainOptions),
                      device="cpu")
        tstate = load_checkpoint(INIT, template=ttr.init_state(
            torch.Generator().manual_seed(0)))
        assert ttr.opts.lr == 0.02 and ttr.opts.value_loss_weight == 0.25
        tdt = torch.float64 if f64 else torch.float32
        tstate.net.to(tdt)
        tstate.opt_state = _cast_tree(
            tstate.opt_state, lambda t: t.to(tdt) if t.is_floating_point()
            else t)
        before = dict(_leaves(params_to_jax(tstate.net)[0]))

        # four positions; one in float64, where XLA's CPU convolutions
        # are slow
        n = 1 if f64 else 4
        rng = np.random.default_rng(19)
        feats = (rng.random((n, 19, 19, 18)) < 0.3).astype(dt)
        pi = rng.dirichlet(np.full(362, 0.3), size=n).astype(dt)
        winner = rng.choice([-1.0, 1.0], size=n).astype(dt)

        jstate, jstats = jax.jit(jtr.make_train_step())(
            jstate, feats, pi, winner)
        jstate, jstats = jax.device_get((jstate, jstats))
    finally:
        if f64:
            jax.config.update("jax_enable_x64", x64)
    tstate, tstats = ttr.make_train_step()(
        tstate, torch.from_numpy(feats), torch.from_numpy(pi),
        torch.from_numpy(winner))
    assert tstate.step == int(jstate.step) == 1
    assert tstats.keys() == jstats.keys()
    loss_tol, stat_tol, layer_tol, up_tol = (
        (1e-12, 1e-12, 1e-10, 1e-9) if f64 else (1e-5, 1e-4, 2e-3, 1e-4))
    assert abs(float(tstats["loss/total"]) - float(jstats["loss/total"])) \
        < loss_tol
    for k in jstats:
        ref = float(jstats[k])
        assert abs(float(tstats[k]) - ref) < stat_tol * max(1.0, abs(ref)), k

    params, stats = params_to_jax(tstate.net)
    worst = 0.0
    for ours, ref in ((params, jstate.params), (stats, jstate.batch_stats)):
        ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
        assert ours.keys() == ref.keys()
        layer_scale = {}
        for k, want in ref.items():
            layer = k.rsplit("/", 1)[0]
            layer_scale[layer] = max(layer_scale.get(layer, 0.0),
                                     float(np.abs(want).max()))
        for k, want in ref.items():
            err = float(np.abs(ours[k] - want).max())
            scale = layer_scale[k.rsplit("/", 1)[0]]
            worst = max(worst, err / max(scale, 1e-30))
            assert err <= layer_tol * scale, k

    ours_p, ref_p = dict(_leaves(params)), dict(_leaves(jstate.params))
    # the whole update: its direction and its length
    keys = sorted(before)
    ours_up = np.concatenate([(ours_p[k] - before[k]).ravel() for k in keys])
    ref_up = np.concatenate([(ref_p[k] - before[k]).ravel() for k in keys])
    cos = ours_up @ ref_up / np.linalg.norm(ours_up) / np.linalg.norm(ref_up)
    assert cos > 1.0 - up_tol
    assert abs(np.linalg.norm(ours_up) / np.linalg.norm(ref_up) - 1.0) \
        < up_tol
    worst_up = 0.0
    if f64:
        # each tensor's own update, but the convolutions' biases, whose
        # gradient (a BN follows each) is zero up to rounding
        for k in keys:
            if k.endswith("/bias") and "bn" not in k:
                continue
            up = ref_p[k] - before[k]
            err = float(np.abs(ours_p[k] - before[k] - up).max())
            worst_up = max(worst_up, err / float(np.abs(up).max()))
            assert err <= up_tol * float(np.abs(up).max()), k
    print(f"{width}: layers within {worst:.3e} of their scale, update "
          f"cosine {cos:.9f}, length ratio "
          f"{np.linalg.norm(ours_up) / np.linalg.norm(ref_up):.9f}, "
          f"tensor updates within {worst_up:.3e}")


# ------------------------------------------------------ the eval actor

def _jax_eval_configs(args):
    """(ActorConfig, MCTSConfig, seed) of the JAX proof's eval actor,
    evaluated from `scripts/prove_learning.py`'s own statements."""
    tree = ast.parse(open(prove_learning.__file__).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    wanted = {"size", "n2", "pass_ply", "eval_actor"}
    body = [s for s in main.body if isinstance(s, ast.Assign)
            and isinstance(s.targets[0], ast.Name)
            and s.targets[0].id in wanted]
    assert [s.targets[0].id for s in body] == ["size", "n2", "pass_ply",
                                               "eval_actor"]
    seen = {}

    def capture(acfg, mcfg, builder, seed):
        seen.update(acfg=acfg, mcfg=mcfg, seed=seed)

    ns = {"args": args, "SelfplayActor": capture,
          "ActorConfig": JActorConfig, "MCTSConfig": JMCTSConfig,
          "make_pair_eval_builder": lambda f: None, "eval_raw": None}
    exec(compile(ast.Module(body=body, type_ignores=[]), "prove_learning",
                 "exec"), ns)
    return seen["acfg"], seen["mcfg"], seen["seed"]


@pytest.mark.parametrize("argv", [PROOF19, PROOF19 + ["--komi", "6.5",
                                                      "--eval_games", "2",
                                                      "--c_puct", "2.0"]])
def test_eval_actor_configuration_matches_jax(argv):
    jacfg, jmcfg, jseed = _jax_eval_configs(prove_learning.parse_args(argv))
    args = plt.parse_args(argv)
    actor = plt.make_eval_actor(args, args.board_size, "cpu",
                                lambda net, stats, feats: None)
    assert dataclasses.asdict(actor.cfg) == dataclasses.asdict(jacfg)
    assert dataclasses.asdict(actor.mcts_cfg) == dataclasses.asdict(jmcfg)
    assert actor.gen.initial_seed() == jseed == args.seed + 2
    if argv == PROOF19:
        assert actor.cfg.batch == 32
        assert actor.mcts_cfg.ply_pass_enabled == 160
        assert actor.mcts_cfg.num_rollouts == 64
        assert actor.mcts_cfg.root_epsilon == 0.0
        assert actor.cfg.policy_distri_cutoff == 0
