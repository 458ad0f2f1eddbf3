"""Indexed FASTA sequence access (reference-genome sequence queries).

Parity with the FASTA support behind `ReferenceGenome.add_sequence`
(reference `is/hail/variant/ReferenceGenome.scala` FASTA reader) — a fresh
implementation over the standard .fai index format.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Optional, Tuple


class FastaSequence:
    """Random access into a FASTA file via a .fai index.

    .fai columns: name, length, offset, linebases, linewidth.
    Plain (uncompressed) FASTA is seekable; gzip falls back to full decode.
    """

    def __init__(self, fasta_file: str, index_file: Optional[str] = None):
        self.fasta_file = fasta_file
        index_file = index_file or fasta_file + '.fai'
        self.index: Dict[str, Tuple[int, int, int, int]] = {}
        if os.path.exists(index_file):
            with open(index_file) as f:
                for line in f:
                    parts = line.strip().split('\t')
                    if len(parts) >= 5:
                        name, length, offset, linebases, linewidth = parts[:5]
                        self.index[name] = (int(length), int(offset), int(linebases), int(linewidth))
        self._cache: Dict[str, str] = {}
        self._gzipped = fasta_file.endswith('.gz') or fasta_file.endswith('.bgz')

    def _load_contig(self, contig: str) -> str:
        if contig in self._cache:
            return self._cache[contig]
        opener = gzip.open if self._gzipped else open
        seqs: Dict[str, list] = {}
        cur = None
        with opener(self.fasta_file, 'rt') as f:
            for line in f:
                line = line.strip()
                if line.startswith('>'):
                    cur = line[1:].split()[0]
                    seqs[cur] = []
                elif cur is not None:
                    seqs[cur].append(line)
        for k, v in seqs.items():
            self._cache[k] = ''.join(v)
        if contig not in self._cache:
            raise ValueError(f'contig {contig!r} not found in {self.fasta_file}')
        return self._cache[contig]

    def query(self, contig: str, position: int, before: int = 0, after: int = 0) -> str:
        """1-based position; returns bases [position-before, position+after]."""
        start = max(1, position - before)
        end = position + after
        if not self._gzipped and contig in self.index:
            length, offset, linebases, linewidth = self.index[contig]
            end = min(end, length)
            with open(self.fasta_file, 'rb') as f:
                p0 = start - 1
                p1 = end
                byte0 = offset + (p0 // linebases) * linewidth + (p0 % linebases)
                byte1 = offset + ((p1 - 1) // linebases) * linewidth + ((p1 - 1) % linebases) + 1
                f.seek(byte0)
                raw = f.read(byte1 - byte0)
            return raw.decode().replace('\n', '').replace('\r', '')
        seq = self._load_contig(contig)
        end = min(end, len(seq))
        return seq[start - 1:end]
