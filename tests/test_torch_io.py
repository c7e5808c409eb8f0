"""Port parity: the FASTA/FASTQ codecs (``io/fasta.py``, ``io/fastq.py``).

Seeded records (with descriptions, empty sequences, both phred offsets)
are written by both packages' writers and read back by both packages'
readers, plain and gzip. Tolerance: the written bytes identical and the
records read identical (id, description, sequence, qual); malformed input
raises ``ValueError`` on both sides, and the format sniffers agree."""

import gzip
import io

import numpy as np
import pytest

from proovread_tpu.io import fasta as jfasta
from proovread_tpu.io import fastq as jfastq
from proovread_tpu.io.records import SeqRecord as JRecord

from proovread_tpu_torch.io import fasta as tfasta
from proovread_tpu_torch.io import fastq as tfastq
from proovread_tpu_torch.io.records import SeqRecord


def _records(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(0, 300)) if i else 0
        seq = "".join("ACGTN"[c] for c in rng.integers(0, 5, L))
        desc = f"len={L} SUBSTR:0,{L}" if i % 3 == 0 else ""
        out.append((f"read_{i}", seq, rng.integers(0, 42, L).astype(np.uint8),
                    desc))
    return out


def _key(recs):
    return [(r.id, r.desc, r.seq,
             None if r.qual is None else r.qual.tobytes()) for r in recs]


def _write(writer_cls, rec_cls, recs, **kw):
    buf = io.BytesIO()
    w = writer_cls(buf, **kw)
    offs = [w.write(rec_cls(i, s, qual=q, desc=d)) for i, s, q, d in recs]
    return buf.getvalue(), offs


@pytest.mark.parametrize("phred_offset", [33, 64])
def test_fastq_bytes_and_records_match_jax(tmp_path, phred_offset):
    recs = _records(1)
    jb, joffs = _write(jfastq.FastqWriter, JRecord, recs,
                       phred_offset=phred_offset)
    tb, toffs = _write(tfastq.FastqWriter, SeqRecord, recs,
                       phred_offset=phred_offset)
    assert tb == jb and toffs == joffs
    p = tmp_path / "r.fq"
    p.write_bytes(tb)
    want = _key(jfastq.FastqReader(str(p)))
    assert _key(tfastq.FastqReader(str(p))) == want
    assert tfastq.FastqReader(str(p)).guess_phred_offset() == \
        jfastq.FastqReader(str(p)).guess_phred_offset()
    # a record's offset seeks back to it
    rd = tfastq.FastqReader(str(p))
    rd.seek(toffs[7])
    assert _key([next(rd)]) == want[7:8]


@pytest.mark.parametrize("line_width", [0, 60])
def test_fasta_bytes_and_records_match_jax(tmp_path, line_width):
    recs = [(i, s, None, d) for i, s, _, d in _records(2)]
    jb, _ = _write(jfasta.FastaWriter, JRecord, recs, line_width=line_width)
    tb, _ = _write(tfasta.FastaWriter, SeqRecord, recs,
                   line_width=line_width)
    assert tb == jb
    p = tmp_path / "r.fa"
    p.write_bytes(tb)
    assert _key(tfasta.FastaReader(str(p))) == \
        _key(jfasta.FastaReader(str(p)))


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_gzip_input_matches_jax(tmp_path, fmt):
    recs = _records(3)
    if fmt == "fastq":
        raw, _ = _write(jfastq.FastqWriter, JRecord, recs)
    else:
        raw, _ = _write(jfasta.FastaWriter, JRecord,
                        [(i, s, None, d) for i, s, _, d in recs])
    p = tmp_path / f"r.{fmt}.gz"
    with gzip.open(p, "wb") as fh:
        fh.write(raw)
    assert tfastq.check_format(str(p)) == jfastq.check_format(str(p)) == fmt
    assert _key(tfastq.open_seqfile(str(p))) == \
        _key(jfastq.open_seqfile(str(p)))
    trd = tfastq.open_seqfile(str(p))
    jrd = jfastq.open_seqfile(str(p))
    assert trd.estimate_count() == jrd.estimate_count() == len(recs)


@pytest.mark.parametrize("text", [
    b"@r1\nACGT\nACGT\n!!!!\n",          # missing '+'
    b"@r1\nACGT\n+\n!!!\n",              # truncated qual
    b"r1\nACGT\n+\n!!!!\n",              # no '@'
    b"@r1\nACGT\n+\n!!!\x7f\n",           # phred past 93 at offset 33
])
def test_malformed_fastq_raises_like_jax(tmp_path, text):
    p = tmp_path / "bad.fq"
    p.write_bytes(text)
    msgs = []
    for mod in (jfastq, tfastq):
        with pytest.raises(ValueError) as e:
            list(mod.FastqReader(str(p), phred_offset=33))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_check_format_matches_jax(tmp_path):
    for name, text, want in (("a.fq", b"\n\n@r\nA\n+\n!\n", "fastq"),
                             ("a.fa", b">r\nA\n", "fasta")):
        p = tmp_path / name
        p.write_bytes(text)
        assert tfastq.check_format(str(p)) == jfastq.check_format(str(p)) \
            == want
    bad = tmp_path / "bad.txt"
    bad.write_bytes(b"hello\n")
    for mod in (jfastq, tfastq):
        with pytest.raises(ValueError, match="unrecognized"):
            mod.check_format(str(bad))
    with pytest.raises(TypeError):
        tfastq.check_format(io.BytesIO(b">r\nA\n"))
