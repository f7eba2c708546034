"""The port's training CLI (pase_tpu_torch/train.py) against the JAX CLI
(repo-root train.py): every option string of the JAX parser parses with
its type and default; the reference's dead flags and the compatibility
flags print their notes; the flags of unported items raise naming their
ROADMAP.md item when used and not at their default; the superviser's
flags reach the Trainer's cfg; the legacy z flags
make the JAX CLI's gan_cfg; the GAN recipe's command line parses and
builds its trainer."""

import json

import pytest

import chip_smoke
import train as jax_cli
from pase_tpu_torch import train as port_cli
from test_torch_adversarial import GAN_BANK
from test_torch_train import SMALL_FE
from torch_port_common import port_test_guard  # noqa: F401

# the JAX parser's option strings when this port was written
JAX_OPTION_STRINGS = 88
BASE = ["--synthetic", "--device", "cpu", "--net_cfg", "w.cfg",
        "--fe_cfg", "f.cfg"]


def _actions(parser):
    return {s: a for a in parser._actions for s in a.option_strings}


def _parse(argv):
    return port_cli.build_argparser().parse_args(BASE + argv)


def _sample(action):
    """A command-line value for an option of the JAX parser."""
    if action.nargs == 0:
        return []
    if action.type is int:
        return ["3"]
    if action.type is float:
        return ["0.25"]
    return ["x"] if action.nargs is None or action.nargs != "+" else ["x", "y"]


def test_port_takes_every_jax_option_string():
    jax_actions = _actions(jax_cli.build_argparser())
    port_actions = _actions(port_cli.build_argparser())
    assert len(jax_actions) == JAX_OPTION_STRINGS
    assert set(jax_actions) <= set(port_actions)
    assert set(port_actions) - set(jax_actions) == {"--device"}
    for flag, ja in jax_actions.items():
        pa = port_actions[flag]
        for attr in ("dest", "default", "type", "nargs", "const"):
            assert getattr(pa, attr) == getattr(ja, attr), (flag, attr)
        assert list(pa.choices or []) == list(ja.choices or []), flag
        assert type(pa) is type(ja), flag


@pytest.mark.parametrize("flag", sorted(
    set(_actions(jax_cli.build_argparser())) - {"-h", "--help"}))
def test_no_jax_flag_is_an_argparse_error(flag):
    """Every JAX flag (but help), given a value, parses (no exit code
    2)."""
    action = _actions(jax_cli.build_argparser())[flag]
    value = [action.choices[0]] if action.choices else _sample(action)
    opts = port_cli.build_argparser().parse_args([flag] + value)
    assert hasattr(opts, action.dest)


@pytest.mark.parametrize("flag,value,needle", [
    (f, ["3"] if kw.get("type") is int else ["0.5"]
     if kw.get("type") is float else ["x"], "NO-OP")
    for f, kw in port_cli.DEAD_REFERENCE_FLAGS] + [
    ("--no-cuda", [], "--device"),
    ("--tensorboard", ["False"], "JSONL"),
    ("--cache_on_load", [], "always on"),
    ("--do_eval", [], "evaluated once per epoch"),
    ("--vq", [], "--fe_cfg"),
    ("--vq_K", ["64"], "--fe_cfg"),
    ("--jax_cache_dir", ["/tmp/c"], "TPU-only"),
    ("--no_fused_feed", [], "TPU-only"),
    ("--loss_precision", ["high"], "TPU-only")])
def test_dead_and_compat_flags_print_their_notes(capsys, flag, value,
                                                  needle):
    port_cli.compat_notes(_parse([flag] + value))
    out = capsys.readouterr().out
    assert "[compat]" in out and needle in out and flag in out


def test_defaults_print_no_note(capsys):
    port_cli.compat_notes(_parse([]))
    assert capsys.readouterr().out == ""


def test_no_cuda_does_not_move_the_run():
    opts = _parse(["--no-cuda"])
    assert opts.device == "cpu" and opts.no_cuda
    assert port_cli.build_argparser().parse_args(
        ["--no-cuda"]).device == "cuda"


UNPORTED = [
    ("--alpha", ["0.3"], "item 9e"), ("--delta", ["1.2"], "item 9e"),
    ("--temp", ["2"], "item 9e"), ("--dropout_rate", ["0.2"], "item 9e"),
    ("--rndmin_train", [], "item 9e"), ("--att_K", ["4"], "item 9e"),
    ("--att_mode", ["concat"], "item 9e"),
    ("--avg_factor", ["0.5"], "item 9e"),
    ("--coordinator_address", ["localhost:1"], "item 10"),
    ("--num_processes", ["2"], "item 10"),
    ("--process_id", ["0"], "item 10"), ("--n_model", ["2"], "item 10")]


@pytest.mark.parametrize("flag,value,item", UNPORTED)
def test_unported_flags_raise_naming_their_item(flag, value, item):
    with pytest.raises(NotImplementedError,
                       match=f"{flag} is not ported yet: ROADMAP.md, "
                             f"queue 1, {item}"):
        port_cli.check_ported(_parse([flag] + value))


def test_unported_flags_at_their_defaults_do_not_raise():
    defaults = []
    for flag, _, _ in UNPORTED:
        action = _actions(jax_cli.build_argparser())[flag]
        if action.nargs != 0 and action.default is not None:
            defaults += [flag, str(action.default)]
    assert defaults == ["--dropout_rate", "0.5", "--n_model", "1"]
    port_cli.check_ported(_parse(defaults))


@pytest.mark.parametrize("flag,value,key,want", [
    ("--sup_exec", "sup.cmds", "sup_exec", "sup.cmds"),
    ("--sup_freq", "2", "sup_freq", 2)])
def test_sup_flags_reach_the_trainer_cfg(tmp_path, monkeypatch, flag,
                                         value, key, want):
    """--sup_exec / --sup_freq (the AuxiliarSuperviser's) parse, pass the
    checks and reach the Trainer's cfg (the epoch loop is not run here;
    tests/test_torch_probes.py runs the schedule)."""
    from pase_tpu_torch.trainer import Trainer
    from test_torch_train import small_workers
    fe, wk = tmp_path / "fe.cfg", tmp_path / "wk.cfg"
    fe.write_text(json.dumps(SMALL_FE))
    wk.write_text(json.dumps(small_workers()))
    monkeypatch.setattr(Trainer, "train_", lambda self, *a, **k: None)
    port_cli.check_ported(_parse([flag, value]))
    tr = port_cli.main(["--synthetic", "--device", "cpu", "--net_cfg",
                        str(wk), "--fe_cfg", str(fe), "--batch_size", "2",
                        "--chunk_size", "4800", "--epoch", "2",
                        "--save_path", str(tmp_path / "run"), flag, value])
    assert tr.cfg[key] == want
    assert tr.cfg["fe_cfg"] == str(fe)


Z_CASES = [
    [],                                                    # off
    ["--epoch", "150", "--warmup", "3", "--cchunk_prior", "--adv_loss",
     "L2", "--zinc", "0.001"],
    ["--epoch", "5", "--warmup", "5", "--z_lr", "0.001"],  # final epoch
    ["--epoch", "5", "--warmup", "1", "--zinit_weight", "0.3"],
    ["--epoch", "5", "--warmup", "6", "--cchunk_prior"],   # never: a note
    ["--warmup", "10000000", "--epoch", "400"],            # README PASE+
    ["--epoch", "5", "--warmup", "2", "--adv_loss", "Hinge"],   # error
    ["--epoch", "5", "--warmup", "2", "--gan_cfg", "{}"],       # error
]


@pytest.mark.parametrize("argv", Z_CASES, ids=[
    "off", "l2_prior", "final_epoch", "first_epoch", "never", "readme",
    "bad_adv_loss", "with_gan_cfg"])
@pytest.mark.parametrize("bpe", [1, 50])
def test_compat_z_gan_cfg_is_the_jax_clis(capsys, argv, bpe):
    jopts = jax_cli.build_argparser().parse_args(
        ["--net_cfg", "w.cfg"] + argv)
    popts = _parse(argv)
    try:
        want = jax_cli.compat_z_gan_cfg(jopts, bpe)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            port_cli.compat_z_gan_cfg(popts, bpe)
        return
    want_out = capsys.readouterr().out
    assert port_cli.compat_z_gan_cfg(popts, bpe) == want
    assert capsys.readouterr().out == want_out


def test_the_gan_recipe_parses_and_builds_its_trainer(tmp_path,
                                                      monkeypatch):
    """recipes/run_pase_plus_gan.sh's flags with --synthetic: they pass
    every check, its gan_cfg reaches the Trainer; the legacy z flags
    make a z discriminator with the warm-up in steps. The epoch loop is
    not run here (tests/test_torch_adversarial.py steps the trainer)."""
    from pase_tpu_torch.adversarial import WaveDiscriminator, ZDiscriminator
    from pase_tpu_torch.trainer import Trainer
    argv = chip_smoke.recipe_argv("recipes/run_pase_plus_gan.sh")
    gan = json.loads(argv[argv.index("--gan_cfg") + 1])
    assert gan == {"worker": "cchunk", "loss": "LSGAN", "lr": 0.0004,
                   "weight": 1.0}
    opts = port_cli.build_argparser().parse_args(
        argv + ["--synthetic", "--device", "cpu"])
    port_cli.compat_notes(opts)
    port_cli.check_ported(opts)
    assert port_cli.compat_z_gan_cfg(opts, 100) is None

    fe, wk = tmp_path / "fe.cfg", tmp_path / "wk.cfg"
    fe.write_text(json.dumps(SMALL_FE))
    wk.write_text(json.dumps(GAN_BANK))
    monkeypatch.setattr(Trainer, "train_", lambda self, *a, **k: None)
    common = ["--synthetic", "--device", "cpu", "--net_cfg", str(wk),
              "--fe_cfg", str(fe), "--batch_size", "2", "--chunk_size",
              "4800", "--epoch", "3"]
    tr = port_cli.main(common + ["--save_path", str(tmp_path / "w"),
                                 "--gan_cfg", json.dumps(gan)])
    assert tr.gan_cfg == gan
    assert isinstance(tr.discriminator, WaveDiscriminator)
    tr = port_cli.main(common + ["--save_path", str(tmp_path / "z"),
                                 "--warmup", "2", "--cchunk_prior",
                                 "--z_lr", "0.001"])
    assert tr.gan_cfg == {"type": "z", "warmup": 100, "zinit_weight": 1.0,
                          "zinc": 0.0002, "lr": 0.001, "loss": "BCE",
                          "cchunk_prior": True}
    assert isinstance(tr.discriminator, ZDiscriminator)
    assert tr.model.fwd_cchunk
    assert tr.d_opt.param_groups[0]["lr"] == 0.001
