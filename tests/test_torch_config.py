"""Port parity: ``config.py`` (defaults, layering, task-scoped resolution,
task lists, the template, ``mode_auto``), the task-to-pipeline settings of
``pipeline/tasks.py`` and ``align/params.py``'s ``from_bwa_flags`` /
``from_shrimp_flags``.

Each case of ``tests/test_cli.py``'s ``TestConfig`` and ``TestModeAuto``
runs against both packages. Tolerance: equal results (dataclasses compared
field by field), equal template bytes and equal error messages."""

import dataclasses
import itertools

import pytest

import proovread_tpu.config as jconfig
import proovread_tpu.pipeline.tasks as jtasks
from proovread_tpu.align import params as jparams

import proovread_tpu_torch.config as tconfig
import proovread_tpu_torch.pipeline.tasks as ttasks
from proovread_tpu_torch.align import params as tparams


def _plain_key(cfgmod, tasks, tmp):
    c = cfgmod.Config()
    return c.get("mask-shortcut-frac"), c.get("unknown-key", default="d")


def _task_scoped(cfgmod, tasks, tmp):
    c = cfgmod.Config()
    return [c.get(k, t) for k in ("sr-coverage", "hcr-mask",
                                  "detect-chimera", "qual-weighted")
            for t in (None, "bwa-sr-3", "bwa-sr-finish", "bwa-sr-4",
                      "bwa-mr-6", "utg", "ccs-1")]


def _counter_strip(cfgmod, tasks, tmp):
    return cfgmod.Config().get("sr-coverage-3")


def _layering(cfgmod, tasks, tmp):
    p = tmp / "user.cfg"
    p.write_text('// comment\n{"sr-coverage": {"DEF": 99},\n'
                 '"mask-shortcut-frac": 0.5,}\n')
    c = cfgmod.Config.load(str(p))
    return (c.get("sr-coverage"), c.get("sr-coverage", "bwa-sr-finish"),
            c.get("mask-shortcut-frac"), c.dump())


def _tasks_lists(cfgmod, tasks, tmp):
    c = cfgmod.Config()
    out = {m: c.tasks(m) for m in c.data["mode-tasks"]}
    with pytest.raises(ValueError) as e:
        c.tasks("bogus")
    return out, str(e.value)


def _template(cfgmod, tasks, tmp):
    p = tmp / "template.cfg"
    cfgmod.Config.create_template(str(p))
    text = p.read_text()
    lines = text.split("\n")
    for i, ln in enumerate(lines):
        if '"sr-chunk-number"' in ln:
            lines[i] = ln[2:].replace("1000", "777")
            break
    p2 = tmp / "edited.cfg"
    p2.write_text("\n".join(lines))
    return (text, cfgmod.Config.load(str(p)).data,
            cfgmod.Config.load(str(p2)).get("sr-chunk-number"))


def _mode_auto(cfgmod, tasks, tmp):
    return [cfgmod.mode_auto(sr, utg, sub, sam=sam, bam=bam)
            for sr, utg, sub, sam, bam in itertools.product(
                (None, 0, 100, 150, 151, 250), (False, True), (False, True),
                (False, True), (False, True))]


def _mapper_schedule(cfgmod, tasks, tmp):
    p = tmp / "user.cfg"
    p.write_text('{"bwa-opt": {"DEF": {"-k": 15, "-T": 3.5}},'
                 ' "sr-chunk-number": 50, "sr-chunk-step": 5,'
                 ' "sr-trim": 0}')
    out = []
    for c in (cfgmod.Config(), cfgmod.Config.load(str(p))):
        for base in ("sr", "mr"):
            mode = f"{base}-noccs"
            pc = tasks._pipeline_config(c, mode, c.tasks(mode), 30.0, None,
                                        True)
            d = dataclasses.asdict(pc)
            d.pop("device", None)            # the port's own field
            out.append(d)
    return out


CASES = [_plain_key, _task_scoped, _counter_strip, _layering, _tasks_lists,
         _template, _mode_auto, _mapper_schedule]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__.strip("_"))
def test_config_matches_jax(tmp_path, case):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = case(jconfig, jtasks, tmp_path / "j")
    got = case(tconfig, ttasks, tmp_path / "t")
    assert got == want


def _all_tasks():
    modes = jconfig.DEFAULTS["mode-tasks"]
    return sorted({t for ts in modes.values() for t in ts})


@pytest.mark.parametrize("task", _all_tasks())
def test_align_flags_match_jax(task):
    """Every task of DEFAULTS through the flag parsers: bwa-opt's DEF
    merged with the task's own flags (-N counter stripping), and the
    SHRiMP2 flags of the legacy schedule."""
    def resolve(cfgmod, pmod):
        c = cfgmod.Config()
        bw = c.data["bwa-opt"]
        flags = dict(bw["DEF"])
        flags.update(bw.get(task, bw.get(task.rsplit("-", 1)[0], {})))
        out = [dataclasses.asdict(pmod.from_bwa_flags(flags))]
        so = c.data["shrimp-opt"].get(task)
        if so is not None:
            out.append(dataclasses.asdict(pmod.from_shrimp_flags(so)))
        return out
    assert resolve(tconfig, tparams) == resolve(jconfig, jparams)
    for name in ("BWA_SR", "BWA_SR_FINISH", "BWA_MR_1", "BWA_MR",
                 "BWA_MR_FINISH"):
        assert dataclasses.asdict(getattr(tparams, name)) == \
            dataclasses.asdict(getattr(jparams, name))
