"""Plain readers of the files a smoothing job reads and writes: GFA paths
spelled from their segments, and MAF alignment blocks.  Nothing here comes
from the program under test."""
from __future__ import annotations

from dataclasses import dataclass

_COMP = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def revcomp(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


def read_gfa_paths(path: str) -> dict[str, bytes]:
    """{path name: its sequence} of a GFA 1 file (S and P records; steps
    `<id>+` or `<id>-`)."""
    segs: dict[bytes, bytes] = {}
    plines: list[tuple[bytes, bytes]] = []
    with open(path, "rb") as f:
        for ln in f:
            if ln.startswith(b"S\t"):
                _, sid, seq = ln.rstrip(b"\n").split(b"\t")[:3]
                segs[sid] = seq
            elif ln.startswith(b"P\t"):
                _, name, steps = ln.rstrip(b"\n").split(b"\t")[:3]
                plines.append((name, steps))
    out: dict[str, bytes] = {}
    for name, steps in plines:
        parts = []
        for st in steps.split(b","):
            seq = segs[st[:-1]]
            parts.append(seq if st[-1:] == b"+" else revcomp(seq))
        out[name.decode()] = b"".join(parts)
    return out


@dataclass
class MafRow:
    src: str
    start: int
    size: int
    rev: bool
    src_len: int
    text: bytes


def read_maf(path: str) -> list[list[MafRow]]:
    """The alignment blocks of a MAF file, each its `s` rows in file
    order."""
    blocks: list[list[MafRow]] = []
    cur: list[MafRow] | None = None
    with open(path, "rb") as f:
        for ln in f:
            if ln.startswith(b"a"):
                cur = []
                blocks.append(cur)
            elif ln.startswith(b"s ") and cur is not None:
                _, src, start, size, strand, slen, text = ln.split()
                cur.append(MafRow(src.decode(), int(start), int(size),
                                  strand == b"-", int(slen), text))
    return blocks


def row_source(row: MafRow, seqs: dict[str, bytes]) -> bytes | None:
    """The bases a MAF row claims, read from the input paths (None when
    the path is unknown)."""
    s = seqs.get(row.src)
    if s is None:
        return None
    if row.rev:
        end = row.src_len - row.start
        return revcomp(s[end - row.size:end])
    return s[row.start:row.start + row.size]
