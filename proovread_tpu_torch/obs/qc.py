"""Correction-quality observability: per-read QC provenance + aggregate.

Port of ``proovread_tpu/obs/qc.py`` (host code). One provenance record per
long read as it flows through the pipeline:

- identity: read id, input length, bucket ordinal, bucket span id
  (linking the record into the ``--trace`` span tree),
- the per-iteration masked-fraction trajectory (HCR mask columns /
  read length after each correction pass),
- finish-pass support: admitted short-read alignment count and mean
  column coverage depth,
- correction deltas: corrected-base count (substituted + inserted +
  deleted vs each pass's input) and phred-uplift count (columns whose
  called phred exceeds the input phred), accumulated over all passes,
- chimera breakpoints (coordinates + scores), siamaera hits, CCS
  provenance, and the trim/split funnel (pieces, bases lost per stage),
- ground-truth accuracy (``accuracy`` field): with a truth sidecar (CLI
  ``--truth``; ``obs/accuracy.py``), identity before/after against the
  error-free source, the residual sub/ins/del classes (remaining vs
  introduced) on the classified sample, and chimera-detection correctness
  against the known junctions.

**Zero overhead when off.** Nothing records unless a :class:`QcRecorder`
is installed (CLI ``--qc-out`` or ``--truth``, config ``qc-out``, or
:func:`scope`): pipeline sites check :func:`current` and skip both the
host bookkeeping and the per-row device reductions that feed it
(``pipeline/dcorrect.py:qc_*``).

**Determinism.** Every numeric field is an integer count, or is derived on
the host from integer-exact device sums (float32 sums of integer-valued
series stay exact below 2^24), so the records are the reference's on the
same inputs.

Serialization (``--qc-out FILE``): JSONL, one meta line
(``{"qc_schema": 2, "n_reads": N, "aggregate": {...}}``) followed by one
record object per read, the schema the reference's
``obs/validate.py:QC_RECORD_FIELDS`` declares.
"""

from __future__ import annotations

import json
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Sequence

# v2: the record schema with the per-read ``accuracy`` field
QC_SCHEMA_VERSION = 2

# number of fixed-width bins in the aggregate histograms
_N_BINS = 10

# funnel-table keys of the aggregate report, in render order; also the
# catalog the pipeline pre-declares as qc_* gauges (driver._declare_metrics)
FUNNEL_KEYS = (
    "reads", "reads_corrected", "bases_in", "bases_corrected",
    "chimera_reads", "chimera_breakpoints", "split_pieces",
    "pieces_dropped", "bases_lost_chimera", "bases_lost_trim",
    "bases_out", "siamaera_trimmed", "siamaera_dropped", "ccs_primary",
    "corrected_bases", "phred_uplift",
)


def new_record(read_id: str) -> Dict[str, Any]:
    """A fresh per-read record with every schema field present (the
    writer emits all fields on every record)."""
    return {
        "id": read_id,
        "bucket": None,            # length-bucket ordinal (None: not bucketed)
        "bucket_span": None,       # span_id of the bucket span (None: untraced)
        "in_len": 0,               # input read length entering the pipeline
        "out_len": 0,              # corrected (untrimmed) length
        "n_iterations": 0,         # correction passes before finish
        "masked_frac": [],         # per-iteration HCR-masked fraction
        "finish_admitted": 0,      # SR alignments admitted at the finish pass
        "mean_support": 0.0,       # mean finish column coverage depth
        "corrected_bases": 0,      # subs+ins+dels accumulated over all passes
        "phred_uplift": 0,         # columns whose called phred rose vs input
        "chimera": [],             # [[from, to, score], ...] breakpoints
        "siamaera": None,          # {"action","start","len"} or None
        "ccs": None,               # {"role","n_subreads"} or None
        "trim": None,              # funnel: pieces / bases lost per stage
        "accuracy": None,          # ground-truth scoreboard (--truth;
        #                            obs/accuracy.py score_read_sets)
    }


class QcRecorder:
    """Per-read QC provenance collector for one run.

    Records are keyed by read id and created lazily (a trim event can
    precede the bucket entry). All ``record_*`` methods are host
    bookkeeping over data the pipeline already fetched; the device
    reductions feeding them live in ``pipeline/dcorrect.py`` and run only
    while a recorder is installed."""

    def __init__(self):
        self.records: Dict[str, Dict[str, Any]] = {}
        # optional aggregate cache a caller may set after the run's last
        # record mutation (cli.py stashes the post-scoring aggregate so
        # the artifact write does not rebuild it); aggregate() itself
        # never caches: records mutate freely during the run
        self.last_aggregate: Optional[Dict[str, Any]] = None

    # -- record construction ---------------------------------------------
    def _rec(self, read_id: str) -> Dict[str, Any]:
        r = self.records.get(read_id)
        if r is None:
            r = self.records[read_id] = new_record(read_id)
        return r

    def start_bucket(self, bucket: int, records: Sequence,
                     span_id: Optional[int] = None) -> None:
        """Bucket entry: create/refresh the identity fields of every read
        in the bucket (id, input length, bucket ordinal, bucket span)."""
        for rec in records:
            r = self._rec(rec.id)
            r["bucket"] = int(bucket)
            r["bucket_span"] = span_id
            r["in_len"] = len(rec)

    def record_pass(self, read_ids: Sequence[str],
                    masked_counts, lengths) -> None:
        """One correction pass: append each read's masked fraction
        (integer masked-column count / post-pass length, divided here on
        the host)."""
        for i, rid in enumerate(read_ids):
            r = self._rec(rid)
            n = int(lengths[i])
            r["masked_frac"].append(
                round(int(masked_counts[i]) / max(n, 1), 9))
            r["n_iterations"] = len(r["masked_frac"])

    def record_edits(self, read_ids: Sequence[str], edits, uplift) -> None:
        """Accumulate per-read corrected-base and phred-uplift counts
        (integer deltas of one or more passes)."""
        for i, rid in enumerate(read_ids):
            r = self._rec(rid)
            r["corrected_bases"] += int(edits[i])
            r["phred_uplift"] += int(uplift[i])

    def record_finish(self, read_ids: Sequence[str], out_lens,
                      admitted, support_sums, support_cols) -> None:
        """Finish pass: corrected length, admitted alignment count, and
        mean support depth (integer-exact device sum / column count,
        divided on the host)."""
        for i, rid in enumerate(read_ids):
            r = self._rec(rid)
            r["out_len"] = int(out_lens[i])
            r["finish_admitted"] = int(admitted[i])
            cols = int(support_cols[i])
            r["mean_support"] = round(
                float(support_sums[i]) / max(cols, 1), 6)

    def record_chimera(self, read_id: str,
                       breakpoints: Iterable) -> None:
        self._rec(read_id)["chimera"] = [
            [int(f), int(t), round(float(s), 6)]
            for (f, t, s) in breakpoints]

    def record_ccs(self, read_id: str, role: str, n_subreads: int) -> None:
        self._rec(read_id)["ccs"] = {"role": role,
                                     "n_subreads": int(n_subreads)}

    def record_siamaera(self, read_id: str, action: str,
                        start: int = 0, length: int = 0) -> None:
        """Siamaera hit. The filter runs on TRIMMED records, whose ids
        may carry a chimera-split ``.N`` suffix — those resolve back to
        the parent read's record (one hit per read; a second piece's hit
        overwrites, which still reads as 'this read was siamaeric')."""
        rid = read_id
        if rid not in self.records:
            base, _, sfx = rid.rpartition(".")
            if base and sfx.isdigit() and base in self.records:
                rid = base
        self._rec(rid)["siamaera"] = {
            "action": action, "start": int(start), "len": int(length)}

    def record_trim(self, read_id: str, n_pieces: int,
                    chimera_bases_lost: int, trim_bases_lost: int,
                    pieces_dropped: int, bases_out: int) -> None:
        """Final trim funnel for one read: chimera-split piece count,
        bases lost to the split trim-margins, bases lost to the quality
        window + min-length filter (dropped pieces count whole), and the
        surviving base count."""
        self._rec(read_id)["trim"] = {
            "pieces": int(n_pieces),
            "chimera_bases_lost": int(chimera_bases_lost),
            "trim_bases_lost": int(trim_bases_lost),
            "pieces_dropped": int(pieces_dropped),
            "bases_out": int(bases_out),
        }

    def record_accuracy(self, read_id: str,
                        acc: Optional[Dict[str, Any]]) -> None:
        """Attach one read's ground-truth accuracy verdict
        (``obs/accuracy.py:score_read_sets`` record shape: identity
        before/after, class breakdown, chimera correctness). Runs after
        the pipeline."""
        self._rec(read_id)["accuracy"] = (
            None if acc is None else json.loads(json.dumps(acc)))

    # -- resilience integration ------------------------------------------
    def snapshot(self, read_ids: Sequence[str]) -> Dict[str, Any]:
        """Deep-copy the given reads' records, for rolling a failed bucket
        attempt back."""
        return {rid: json.loads(json.dumps(self.records[rid]))
                for rid in read_ids if rid in self.records}

    def restore(self, read_ids: Sequence[str],
                snap: Dict[str, Any]) -> None:
        for rid in read_ids:
            if rid in snap:
                self.records[rid] = json.loads(json.dumps(snap[rid]))
            else:
                self.records.pop(rid, None)

    def bucket_payload(self, read_ids: Sequence[str]) -> List[Dict]:
        """JSON-safe copies of the given reads' records (checkpoint
        journal payload)."""
        return [json.loads(json.dumps(self.records[rid]))
                for rid in read_ids if rid in self.records]

    def splice(self, payload: Sequence[Dict],
               span_id: Optional[int] = None) -> None:
        """Replay a journal bucket's records (``--resume``). The stored
        ``bucket_span`` pointed into the original run's trace; it is
        rebound to the replaying run's bucket span."""
        for r in payload:
            r = json.loads(json.dumps(r))
            r["bucket_span"] = span_id
            self.records[r["id"]] = r

    # -- aggregation ------------------------------------------------------
    def aggregate(self) -> Dict[str, Any]:
        """The aggregate QC report embedded in ``PipelineResult.qc`` and
        rendered at end of run: fixed-bin histograms of final masked
        fraction, mean support depth and per-read phred uplift, plus the
        chimera/trim funnel table."""
        recs = list(self.records.values())
        n = len(recs)

        def hist(vals, lo=None, hi=None):
            vals = [float(v) for v in vals]
            if not vals:
                return {"min": 0.0, "max": 0.0, "mean": 0.0,
                        "edges": [], "counts": []}
            vlo = min(vals) if lo is None else lo
            vhi = max(vals) if hi is None else hi
            w = (vhi - vlo) / _N_BINS if vhi > vlo else 1.0
            counts = [0] * _N_BINS
            for v in vals:
                k = min(int((v - vlo) / w), _N_BINS - 1) if vhi > vlo else 0
                counts[max(k, 0)] += 1
            return {"min": round(vlo, 6), "max": round(vhi, 6),
                    "mean": round(sum(vals) / len(vals), 6),
                    "edges": [round(vlo + k * w, 6)
                              for k in range(_N_BINS + 1)],
                    "counts": counts}

        final_frac = [r["masked_frac"][-1] for r in recs
                      if r["masked_frac"]]
        trims = [r["trim"] for r in recs if r["trim"] is not None]
        sia = [r["siamaera"] for r in recs if r["siamaera"] is not None]
        funnel = {
            "reads": n,
            "reads_corrected": sum(1 for r in recs if r["out_len"] > 0),
            "bases_in": sum(r["in_len"] for r in recs),
            "bases_corrected": sum(r["out_len"] for r in recs),
            "chimera_reads": sum(1 for r in recs if r["chimera"]),
            "chimera_breakpoints": sum(len(r["chimera"]) for r in recs),
            "split_pieces": sum(t["pieces"] for t in trims),
            "pieces_dropped": sum(t["pieces_dropped"] for t in trims),
            "bases_lost_chimera": sum(t["chimera_bases_lost"]
                                      for t in trims),
            "bases_lost_trim": sum(t["trim_bases_lost"] for t in trims),
            "bases_out": sum(t["bases_out"] for t in trims),
            "siamaera_trimmed": sum(1 for s in sia
                                    if s["action"] == "trimmed"),
            "siamaera_dropped": sum(1 for s in sia
                                    if s["action"] == "dropped"),
            "ccs_primary": sum(1 for r in recs
                               if (r["ccs"] or {}).get("role") == "primary"),
            "corrected_bases": sum(r["corrected_bases"] for r in recs),
            "phred_uplift": sum(r["phred_uplift"] for r in recs),
        }
        # ground-truth accuracy section (obs/accuracy.py): None unless a
        # truth sidecar was scored
        scored = [r["accuracy"] for r in recs
                  if r["accuracy"] is not None]
        acc = None
        if scored:
            # class/chimera sums shared with the flat summary
            from proovread_tpu_torch.obs.accuracy import (chimera_totals,
                                                          class_totals)
            classes = [a["classes"] for a in scored
                       if a["classes"] is not None]
            chim = [a["chimera"] for a in scored
                    if a["chimera"] is not None]
            acc = {
                "n_scored": len(scored),
                "n_classified": len(classes),
                "identity_before": hist(
                    [a["identity_before"] for a in scored],
                    lo=0.0, hi=1.0),
                "identity_after": hist(
                    [a["identity_after"] for a in scored],
                    lo=0.0, hi=1.0),
                "errors_before": class_totals(classes, "before"),
                "errors_after": class_totals(classes, "after"),
                "introduced": class_totals(classes, "introduced"),
                "chimera": chimera_totals(chim),
            }
        return {
            "schema": QC_SCHEMA_VERSION,
            "n_reads": n,
            "histograms": {
                "masked_frac_final": hist(final_frac, lo=0.0, hi=1.0),
                "mean_support": hist([r["mean_support"] for r in recs
                                      if r["out_len"] > 0]),
                "phred_uplift": hist([r["phred_uplift"] for r in recs
                                      if r["out_len"] > 0]),
            },
            "funnel": funnel,
            "accuracy": acc,
        }

    def to_metrics(self, agg: Optional[Dict[str, Any]] = None) -> None:
        """Publish the aggregate counts into the typed metrics registry
        (gauges, so publishing again after the siamaera stage is
        idempotent). Pass a precomputed ``aggregate()`` dict to avoid
        re-walking the records."""
        from proovread_tpu_torch.obs import metrics
        if agg is None:
            agg = self.aggregate()
        g = metrics.gauge
        for key, val in agg["funnel"].items():
            g(f"qc_{key}", unit="", help=f"QC funnel: {key}").set(val)
        g("qc_masked_frac_final_mean", unit="frac").set(
            agg["histograms"]["masked_frac_final"]["mean"])
        g("qc_mean_support_mean", unit="x").set(
            agg["histograms"]["mean_support"]["mean"])
        acc = agg.get("accuracy")
        if acc:
            g("accuracy_reads_scored", unit="reads").set(
                acc["n_scored"])
            g("accuracy_identity_before_mean", unit="frac").set(
                acc["identity_before"]["mean"])
            g("accuracy_identity_after_mean", unit="frac").set(
                acc["identity_after"]["mean"])
            g("accuracy_errors_introduced_total", unit="errors").set(
                sum((acc["introduced"] or {}).values()))

    # -- serialization ----------------------------------------------------
    def iter_records(self) -> List[Dict[str, Any]]:
        """Records in deterministic (insertion) order."""
        return list(self.records.values())

    def write_jsonl(self, path: str,
                    agg: Optional[Dict[str, Any]] = None) -> None:
        """One meta line (schema + aggregate), then one record per line."""
        if agg is None:
            agg = self.aggregate()
        with open(path, "w") as fh:
            fh.write(json.dumps({"qc_schema": QC_SCHEMA_VERSION,
                                 "n_reads": agg["n_reads"],
                                 "aggregate": agg}) + "\n")
            for r in self.iter_records():
                fh.write(json.dumps(r) + "\n")

    def report_lines(self,
                     agg: Optional[Dict[str, Any]] = None) -> List[str]:
        """End-of-run rendering (the span summary's sibling): the funnel
        table plus the three headline histograms."""
        if agg is None:
            agg = self.aggregate()
        f = agg["funnel"]
        lines = [
            f"qc: {f['reads']} read(s) — {f['bases_in']} bases in, "
            f"{f['bases_corrected']} corrected, {f['bases_out']} out "
            f"after trim",
            f"qc: funnel — {f['chimera_reads']} chimeric read(s) / "
            f"{f['chimera_breakpoints']} breakpoint(s), "
            f"{f['split_pieces']} piece(s) ({f['pieces_dropped']} "
            f"dropped), lost {f['bases_lost_chimera']} chimera / "
            f"{f['bases_lost_trim']} trim bases; siamaera "
            f"{f['siamaera_trimmed']} trimmed / "
            f"{f['siamaera_dropped']} dropped",
            f"qc: corrections — {f['corrected_bases']} base edit(s), "
            f"{f['phred_uplift']} phred-uplifted column(s)",
        ]
        acc = agg.get("accuracy")
        if acc:
            intro = sum((acc["introduced"] or {}).values()) \
                if acc["introduced"] is not None else None
            lines.append(
                f"qc: accuracy — {acc['n_scored']} read(s) scored vs "
                f"truth, identity "
                f"{acc['identity_before']['mean']:.4f} -> "
                f"{acc['identity_after']['mean']:.4f}"
                + (f"; {intro} error(s) introduced over "
                   f"{acc['n_classified']} classified read(s)"
                   if intro is not None else ""))
        for name, h in agg["histograms"].items():
            if not h["counts"]:
                continue
            lines.append(
                f"qc: {name:<20} mean {h['mean']:<10g} "
                f"[{h['min']:g}..{h['max']:g}]  "
                + " ".join(str(c) for c in h["counts"]))
        return lines


# -- module-level installation (mirrors obs.metrics) -----------------------

# install() is process-global, scope() is thread-local: the same
# two-level discipline as obs.metrics
_installed: Optional[QcRecorder] = None
_tls = threading.local()


def current() -> Optional[QcRecorder]:
    rec = getattr(_tls, "rec", None)
    return rec if rec is not None else _installed


def enabled() -> bool:
    return current() is not None


def install(rec: Optional[QcRecorder] = None) -> QcRecorder:
    global _installed
    _installed = rec if rec is not None else QcRecorder()
    return _installed


def uninstall() -> None:
    global _installed
    _installed = None


@contextmanager
def scope(rec: Optional[QcRecorder] = None):
    """Yield the active recorder, or install a fresh (or given) one for
    the block in THIS thread — same reuse semantics as
    ``obs.metrics.scope``."""
    cur = current()
    if rec is None and cur is not None:
        yield cur
        return
    prev = getattr(_tls, "rec", None)
    _tls.rec = rec if rec is not None else QcRecorder()
    try:
        yield _tls.rec
    finally:
        _tls.rec = prev
