"""Config system — the role of ``proovread.cfg`` + ``lib/Cfg.pm`` +
``bin/proovread``'s ``cfg()`` resolver.

The port's own copy of ``proovread_tpu/config.py``: the same defaults,
layering and resolution, so a user config file means the same to both
packages and ``parameter.log`` records the same config.

The reference's config is an executable Perl hash with three load-bearing
behaviors this module reproduces: (1) **config IS the pipeline definition**
(``mode-tasks`` maps mode names to task lists, ``proovread.cfg:105-142``);
(2) **task-scoped resolution**: a key may hold a plain value or a
``{DEF, task: override}`` map, looked up by task id with trailing-counter
stripping (``bwa-sr-3`` falls back to ``bwa-sr``) and DEF fallback
(``bin/proovread:1989-2024``); (3) **layering**: built-in defaults <- user
config file <- CLI flags (``bin/proovread:96-126``).

File format: JSON with ``//`` line comments (a data format, not executable
code — deliberate deviation from the Perl ``do``-file; documented in
``create_template``).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

def _bwa_def() -> Dict[str, Any]:
    """The DEF mapper flags, derived from the AlignParams dataclass defaults
    so there is exactly one source of truth (from_bwa_flags also falls back
    to those defaults for any flag a user DEF override drops)."""
    from proovread_tpu_torch.align.params import AlignParams

    p = AlignParams()
    return {"-A": p.match, "-B": p.mismatch,
            "-O": f"{p.o_del},{p.o_ins}", "-E": f"{p.e_del},{p.e_ins}",
            "-L": p.clip, "-k": p.min_seed_len, "-w": p.band_width,
            "-T": p.min_out_score, "-c": p.max_occ}


# Built-in defaults. Semantic parity with proovread.cfg:105-302; values are
# config parity (category b), not code.
DEFAULTS: Dict[str, Any] = {
    "mode-tasks": {
        "sr": ["read-long", "ccs-1", "bwa-sr-1", "bwa-sr-2", "bwa-sr-3",
               "bwa-sr-4", "bwa-sr-5", "bwa-sr-6", "bwa-sr-finish"],
        "mr": ["read-long", "ccs-1", "bwa-mr-1", "bwa-mr-2", "bwa-mr-3",
               "bwa-mr-4", "bwa-mr-5", "bwa-mr-6", "bwa-mr-finish"],
        "sr+utg": ["read-long", "ccs-1", "utg", "bwa-sr-1", "bwa-sr-2",
                   "bwa-sr-3", "bwa-sr-4", "bwa-sr-5", "bwa-sr-6",
                   "bwa-sr-finish"],
        "mr+utg": ["read-long", "ccs-1", "utg", "bwa-mr-1", "bwa-mr-2",
                   "bwa-mr-3", "bwa-mr-4", "bwa-mr-5", "bwa-mr-6",
                   "bwa-mr-finish"],
        "sr-noccs": ["read-long", "bwa-sr-1", "bwa-sr-2", "bwa-sr-3",
                     "bwa-sr-4", "bwa-sr-5", "bwa-sr-6", "bwa-sr-finish"],
        "mr-noccs": ["read-long", "bwa-mr-1", "bwa-mr-2", "bwa-mr-3",
                     "bwa-mr-4", "bwa-mr-5", "bwa-mr-6", "bwa-mr-finish"],
        "sr+utg-noccs": ["read-long", "utg", "bwa-sr-1", "bwa-sr-2",
                         "bwa-sr-3", "bwa-sr-4", "bwa-sr-5", "bwa-sr-6",
                         "bwa-sr-finish"],
        "mr+utg-noccs": ["read-long", "utg", "bwa-mr-1", "bwa-mr-2",
                         "bwa-mr-3", "bwa-mr-4", "bwa-mr-5", "bwa-mr-6",
                         "bwa-mr-finish"],
        "sam": ["read-long", "read-sam"],
        "bam": ["read-long", "read-bam"],
        "utg": ["read-long", "ccs-1", "utg"],
        "utg-noccs": ["read-long", "utg"],
        # 2014-publication schedule (proovread.cfg:140), SHRiMP2 params
        # mapped onto the jax mapper ("shrimp-opt" below)
        "legacy": ["read-long", "shrimp-pre-1", "shrimp-pre-2",
                   "shrimp-pre-3", "shrimp-finish"],
    },
    "sr-coverage": {"DEF": 15,
                    "bwa-sr-finish": 30, "bwa-mr-finish": 30},
    "sr-chunk-number": 1000,
    "sr-chunk-step": 20,
    "sr-trim": 1,
    "sr-indel-taboo-length": 7,
    "sr-indel-taboo": 0.1,
    "detect-chimera": {"DEF": 0, "bwa-sr-finish": 1, "bwa-mr-finish": 1,
                       "shrimp-finish": 1, "read-sam": 1, "read-bam": 1},
    # phred-min,phred-max,mask-min-len,unmask-min-len,mask-reduce,end-ratio
    "hcr-mask": {"DEF": "20,41,80,130,60,0.7",
                 "bwa-sr-4": "20,41,80,130,60,0.3",
                 "bwa-sr-5": "20,41,80,130,60,0.3",
                 "bwa-sr-6": "20,41,80,130,60,0.3",
                 "bwa-mr-4": "20,41,80,130,60,0.3",
                 "bwa-mr-5": "20,41,80,130,60,0.3",
                 "bwa-mr-6": "20,41,80,130,60,0.3"},
    "mask-shortcut-frac": 0.92,
    "mask-min-gain-frac": 0.03,
    "chunk-size": 100,
    "coverage-scale-factor": 0.75,
    "bin-size": {"DEF": 20},
    "max-coverage": {"DEF": 50},
    "rep-coverage": {"DEF": 0, "utg": 7},
    "min-ncscore": {"DEF": None, "utg": 3.3},
    "qual-weighted": {"DEF": 0, "utg": 1, "ccs-1": 1},
    "fallback-phred": {"DEF": 1, "utg": 30},
    "max-ins-length": {"DEF": 0, "utg": 10},
    "seq-filter": {"--trim-win": "12,5", "--min-length": 500},
    "chimera-filter": {"--min-score": 0.2, "--trim-length": 20},
    "siamaera": {},            # set to None to deactivate
    "ccs": {"--min-subreads": 2, "--window": 512, "--overlap": 64,
            "--batch-refs": 256},
    # legacy-mode mapper schedule in SHRiMP2 gmapper flag form
    # (proovread.cfg:386-461; resolved by align.params.from_shrimp_flags)
    "shrimp-opt": {
        "shrimp-pre-1": {"-h": "55%", "-s": "1" * 11, "-w": "130%",
                         "--match": 5, "--mismatch": -11, "--open-r": -2,
                         "--open-q": -1, "--ext-r": -4, "--ext-q": -3},
        "shrimp-pre-2": {"-h": "55%", "-s": "1" * 10, "-w": "140%",
                         "-r": "45%", "--match": 5, "--mismatch": -11,
                         "--open-r": -2, "--open-q": -1, "--ext-r": -4,
                         "--ext-q": -3},
        "shrimp-pre-3": {"-h": "50%", "-s": "11111111,1111110000111111",
                         "-w": "140%", "-r": "35%", "--match": 5,
                         "--mismatch": -11, "--open-r": -2, "--open-q": -1,
                         "--ext-r": -4, "--ext-q": -3},
        "shrimp-pre-4": {"-h": "35%", "-s": "1111111,111101111",
                         "-w": "150%", "-r": "25%", "--match": 5,
                         "--mismatch": -11, "--open-r": -2, "--open-q": -1,
                         "--ext-r": -4, "--ext-q": -3},
        "shrimp-finish": {"-h": "90%", "-s": "1" * 20, "--match": 5,
                          "--mismatch": -10, "--open-r": -5, "--open-q": -5,
                          "--ext-r": -2, "--ext-q": -2},
    },
    # mapper schedules in bwa-proovread flag form (the cfg IS the mapper
    # schedule, proovread.cfg:305-460): DEF merged with per-task overrides,
    # -N counter stripping applies ("bwa-sr-3" -> "bwa-sr" -> DEF)
    "bwa-opt": {
        "DEF": _bwa_def(),
        "bwa-sr-finish": {"-B": 13, "-O": "15,19", "-E": "3,3", "-k": 17,
                          "-w": 30, "-T": 4.0},
        "bwa-mr": {"-k": 13, "-T": 3.0},
        "bwa-mr-1": {},
        "bwa-mr-finish": {"-B": 13, "-O": "15,19", "-E": "3,3", "-k": 19,
                          "-w": 30, "-T": 4.0},
    },
    "lr-min-length": None,     # default: 2 x median sr length
    "utg-window": 512,         # unitig query windowing for the banded kernel
    "utg-overlap": 64,
    # engine knobs (TPU additions; no reference counterpart)
    "engine": "device",
    "batch-reads": 256,
    "device-chunk": 8192,
    # candidates per host-path SW slab (engine="scan" and the resilience
    # ladder's host-scan rung)
    "host-chunk-rows": 4096,
    "seed-stride": 8,
    # device bytes allowed for the resident short-read set; larger sets
    # stream per-pass slabs instead (driver._SrDevice)
    "sr-device-budget": 2147483648,
    # directory for the --debug admitted-alignment SAM dumps (set by the
    # CLI to the output dir; bam2cns --debug's filtered-BAM role)
    "debug-dir": None,
    # -- resilience (pipeline/resilience.py; docs/RESILIENCE.md) ----------
    # per-bucket checkpoint journal dir (the CLI points this at
    # <out>/.proovread_ckpt unless --no-checkpoint); None disables
    "checkpoint-dir": None,
    # 1 = replay completed buckets from the journal (--resume)
    "resume": 0,
    # per-bucket soft wall-clock budget in seconds (null = no budget);
    # a breach counts as a 'timeout' fault and demotes the bucket
    "bucket-timeout": None,
    # 1 = degradation ladder on device faults (fused -> eager ->
    # chunk-halved -> host-scan); 0 = fail fast
    "resilience-ladder": 1,
    # fault-injection spec (testing/faults.py grammar, e.g.
    # "compile@b0.p2;oom@b1"); null reads the PROOVREAD_FAULT env var
    "fault-spec": None,
    # -- multi-chip mesh (parallel/dmesh.py; docs/RESILIENCE.md "Mesh
    # fault domains") -----------------------------------------------------
    # shard iteration passes over this many devices (dp axis); null/0/1 =
    # single-device. Deliberately NOT part of the checkpoint fingerprint:
    # a journal written under one mesh shape resumes under another
    "mesh-shards": None,
    # static per-shard candidate budget of the sharded step, in units of
    # device-chunk; a pass that would overflow it retreats to the
    # single-device rung ('cap_overflow'), never truncates silently
    "mesh-chunks-per-shard": 2,
    # soft wall-clock budget per sharded iteration pass in seconds; a
    # breach is a 'straggler' mesh fault (null = no budget)
    "mesh-pass-timeout": None,
    # -- observability (proovread_tpu/obs; docs/OBSERVABILITY.md) ---------
    # span-tree trace as Chrome trace-event JSONL (Perfetto-loadable);
    # the CLI --trace flag overrides. null = tracing off (default)
    "trace-file": None,
    # typed KPI counters/gauges/histograms as one JSON object; the CLI
    # --metrics-out flag overrides. null = no dump (metrics are still
    # embedded in PipelineResult.metrics per run)
    "metrics-out": None,
    # per-read correction-QC provenance JSONL + aggregate report
    # (obs/qc.py); the CLI --qc-out flag overrides. null = QC off
    "qc-out": None,
    # compile-ledger JSONL (obs/compilecache.py): the kernel library's
    # build window and each kernel entry's first call, with the census;
    # the CLI --compile-ledger flag overrides. null = ledger off
    "compile-ledger": None,
    # kernel-library cache directory: a path, or "auto" for the usual
    # build directory (kernels.build_dir); the CLI --compile-cache flag
    # overrides. null = the usual build directory, hits not marked
    "compile-cache-dir": None,
}

_COMMENT_RE = re.compile(r"^\s*//.*$", re.M)
_TRAILING_COMMA_RE = re.compile(r",(\s*[}\]])")
_CTR_RE = re.compile(r"-\d+$")


class Config:
    """Layered, task-scoped configuration."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        self.data: Dict[str, Any] = json.loads(json.dumps(DEFAULTS))
        if data:
            self.update(data)

    # -- layering ---------------------------------------------------------
    def update(self, other: Dict[str, Any]) -> None:
        """Merge a layer: scalar keys replace; dict values merge key-wise
        (so a user file can override just ``{"DEF": ...}``)."""
        for k, v in other.items():
            if (isinstance(v, dict) and isinstance(self.data.get(k), dict)):
                self.data[k].update(v)
            else:
                self.data[k] = v

    @classmethod
    def load(cls, path: Optional[str] = None) -> "Config":
        cfg = cls()
        if path:
            text = _COMMENT_RE.sub("", open(path).read())
            # tolerate trailing commas: uncommenting a single template line
            # legitimately leaves one before the closing brace
            text = _TRAILING_COMMA_RE.sub(r"\1", text)
            cfg.update(json.loads(text))
        return cfg

    # -- task-scoped resolution (bin/proovread:1989-2024) ----------------
    def get(self, key: str, task: Optional[str] = None, default=None):
        """Resolve ``key``: plain values return as-is; ``{DEF, task: v}``
        maps resolve by exact task id, then with the trailing ``-N``
        counter stripped, then DEF."""
        if key not in self.data:
            key = _CTR_RE.sub("", key)
            if key not in self.data:
                return default
        v = self.data[key]
        if not isinstance(v, dict) or "DEF" not in v:
            return v
        out = v.get("DEF", default)
        if task is not None:
            if task in v:
                out = v[task]
            else:
                base = _CTR_RE.sub("", task)
                if base in v:
                    out = v[base]
        return out

    def tasks(self, mode: str) -> List[str]:
        mt = self.data["mode-tasks"]
        if mode not in mt:
            raise ValueError(
                f"unknown mode {mode!r} (known: {', '.join(sorted(mt))})")
        return list(mt[mode])

    # -- template ---------------------------------------------------------
    def dump(self) -> str:
        return json.dumps(self.data, indent=2)

    @staticmethod
    def create_template(path: str) -> None:
        """Emit a fully-commented config template (every line commented out,
        like the reference's --create-cfg, ``bin/proovread:1779-1799``)."""
        body = json.dumps(DEFAULTS, indent=2)
        lines = ["// proovread-tpu configuration template.",
                 "// Uncomment and edit keys to override built-in defaults;",
                 "// dict-valued keys merge key-wise ({\"DEF\": ...} +",
                 "// per-task overrides, resolved with -N counter stripping).",
                 "// Uncomment WHOLE key blocks (a multi-line value needs",
                 "// all its lines); trailing commas are tolerated.",
                 "{"]
        for ln in body.split("\n")[1:-1]:
            lines.append("//" + ln)
        lines.append("}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")


def mode_auto(min_sr_len: Optional[int], have_utg: bool,
              have_subreads: bool, sam: bool = False,
              bam: bool = False) -> str:
    """Mode auto-detection (bin/proovread:625-654 + noccs fallback
    :1512-1517)."""
    if bam:
        return "bam"
    if sam:
        return "sam"
    if not min_sr_len:
        mode = "utg" if have_utg else "sr"
    elif min_sr_len > 150:
        mode = "mr"
    else:
        mode = "sr"
    if have_utg and "utg" not in mode:
        mode += "+utg"
    if not have_subreads and mode not in ("sam", "bam"):
        mode += "-noccs"
    return mode
