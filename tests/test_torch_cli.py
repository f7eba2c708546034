"""The port's training CLI (pase_tpu_torch/train.py) against the JAX CLI
(repo-root train.py): every option string of the JAX parser parses with
its type and default; the reference's dead flags and the compatibility
flags print their notes; the flags of unported items raise naming their
ROADMAP.md item when used and not at their default; the policy and
attention flags reach the Trainer as the JAX CLI routes them; the
superviser's
flags reach the Trainer's cfg; the legacy z flags
make the JAX CLI's gan_cfg; the GAN recipe's command line parses and
builds its trainer."""

import json
import re

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


# the multi-process flags, ported (tests/test_torch_parallel.py,
# tests/test_torch_sharded_corpus.py, tests/test_torch_tensor_parallel.py
# run them)
MULTI_PROCESS = [("--coordinator_address", ["localhost:1"]),
                 ("--num_processes", ["2"]), ("--process_id", ["0"]),
                 ("--shard_device_corpus", ["--device_corpus"])]


@pytest.mark.parametrize("n_model,processes", [(2, 2), (4, 4), (2, 4)])
def test_n_model_grids_pass_the_check(n_model, processes):
    """--n_model that divides --num_processes passes (the grid n_data x
    n_model), as the JAX CLI takes the flag."""
    port_cli.check_ported(_parse(["--n_model", str(n_model),
                                  "--num_processes", str(processes)]))


@pytest.mark.parametrize("n_model,processes", [(2, None), (4, 2), (3, 4)])
def test_n_model_that_does_not_divide_raises(n_model, processes):
    argv = ["--n_model", str(n_model)]
    if processes:
        argv += ["--num_processes", str(processes)]
    with pytest.raises(ValueError, match=f"--n_model {n_model} must divide "
                                         "the number of processes"):
        port_cli.check_ported(_parse(argv))


@pytest.mark.parametrize("flag,value", MULTI_PROCESS)
def test_multi_process_flags_pass_the_check(flag, value):
    port_cli.check_ported(_parse([flag] + value))


def test_jax_cli_defaults_pass_the_check():
    """Every JAX CLI flag at its default passes (--n_model 1 among
    them)."""
    defaults = []
    for flag, action in _actions(jax_cli.build_argparser()).items():
        if flag == "--n_model":
            defaults += [flag, str(action.default)]
    assert defaults == ["--n_model", "1"]
    port_cli.check_ported(_parse(defaults))


ATT_CFG = "cfg/attention.cfg"
# the policy and attention flags (formerly refused): each case's flag, its
# value, and what it must make of the Trainer the CLI builds
VARIANT_FLAGS = [
    ("--alpha", ["0.3"], lambda tr: tr.pol_kwargs["alpha_ema"] == 0.3),
    ("--delta", ["1.2"], lambda tr: tr.pol_kwargs["delta"] == 1.2),
    ("--temp", ["2"], lambda tr: tr.pol_kwargs["temp"] == 2.0),
    ("--dropout_rate", ["0.2"],
     lambda tr: tr.pol_kwargs["dropout_rate"] == 0.2),
    ("--rndmin_train", [], lambda tr: tr.mode == "select_one"),
    ("--att_K", ["4", "--att_cfg", ATT_CFG],
     lambda tr: tr.model.att_mi.K == 4),
    ("--att_mode", ["concat", "--att_cfg", ATT_CFG],
     lambda tr: tr.model.att_mi.att_mode == "concat"
     and tr.model.att_mi.mlp_0.in_features == 16 * 30),
    ("--avg_factor", ["0.5", "--att_cfg", ATT_CFG],
     lambda tr: tr.model.att_lps.avg_factor == 0.5)]


@pytest.mark.parametrize("flag,value,want", VARIANT_FLAGS,
                         ids=[f for f, _, _ in VARIANT_FLAGS])
def test_variant_flags_reach_the_trainer(tmp_path, monkeypatch, capsys,
                                         flag, value, want):
    """Each policy / attention flag passes the checks, prints the JAX
    CLI's note, leaves the options as the JAX CLI's
    ``apply_reference_compat`` leaves them (backprop_mode, att_cfg) and
    reaches the Trainer (the epoch loop is not run here)."""
    from pase_tpu_torch.trainer import Trainer
    from test_torch_train import small_workers
    jopts = jax_cli.build_argparser().parse_args(
        ["--net_cfg", "w.cfg", flag] + value)
    jax_cli.apply_reference_compat(jopts)
    want_notes = [line for line in capsys.readouterr().out.splitlines()
                  if "rndmin" in line or "attention" in line]
    fe, wk = tmp_path / "fe.cfg", tmp_path / "wk.cfg"
    fe.write_text(json.dumps(SMALL_FE))
    wk.write_text(json.dumps(small_workers()))
    monkeypatch.setattr(Trainer, "train_", lambda self, *a, **k: None)
    tr = port_cli.main(["--synthetic", "--device", "cpu", "--net_cfg",
                        str(wk), "--fe_cfg", str(fe), "--batch_size", "2",
                        "--chunk_size", "4800", "--epoch", "1",
                        "--save_path", str(tmp_path / "run"), flag] + value)
    notes = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[compat]")]
    assert notes == want_notes
    assert tr.cfg["backprop_mode"] == jopts.backprop_mode
    assert tr.cfg["att_cfg"] == jopts.att_cfg
    assert want(tr)


def test_attention_overrides_need_att_cfg_as_in_jax():
    jopts = jax_cli.build_argparser().parse_args(
        ["--net_cfg", "w.cfg", "--att_K", "4"])
    with pytest.raises(ValueError) as e:
        jax_cli.apply_reference_compat(jopts)
    with pytest.raises(ValueError, match=re.escape(str(e.value))):
        port_cli.resolve_variant_flags(_parse(["--att_K", "4"]))
    for mode in ("softmax", "MGD"):
        argv = ["--rndmin_train", "--backprop_mode", mode]
        with pytest.raises(ValueError) as e:
            jax_cli.apply_reference_compat(jax_cli.build_argparser(
            ).parse_args(["--net_cfg", "w.cfg"] + argv))
        with pytest.raises(ValueError, match=re.escape(str(e.value))):
            port_cli.resolve_variant_flags(_parse(argv))


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
