"""Genome liftover over UCSC chain files.

Parity with `ReferenceGenome.add_liftover` / `hl.liftover` in the reference
(backed there by htsjdk LiftOver) — a fresh implementation of the UCSC chain
format with an interval lookup per source contig.
"""

from __future__ import annotations

import bisect
import gzip
from typing import Dict, List, Optional, Tuple


class _ChainBlock:
    __slots__ = ('s_start', 's_end', 't_contig', 't_start', 't_strand', 't_size', 'score')

    def __init__(self, s_start, s_end, t_contig, t_start, t_strand, t_size, score):
        self.s_start = s_start
        self.s_end = s_end
        self.t_contig = t_contig
        self.t_start = t_start
        self.t_strand = t_strand
        self.t_size = t_size
        self.score = score


class LiftOver:
    def __init__(self, chain_file: str, src_rg, dest_rg):
        self.src_rg = src_rg
        self.dest_rg = dest_rg
        # per source contig: sorted list of (s_start, block)
        self.blocks: Dict[str, List[Tuple[int, _ChainBlock]]] = {}
        self._parse(chain_file)
        self._starts: Dict[str, List[int]] = {
            c: [s for s, _ in blks] for c, blks in self.blocks.items()
        }

    def _parse(self, chain_file: str) -> None:
        opener = gzip.open if chain_file.endswith('.gz') else open
        with opener(chain_file, 'rt') as f:
            header = None
            s_pos = t_pos = 0
            for line in f:
                line = line.strip()
                if not line:
                    header = None
                    continue
                if line.startswith('chain'):
                    parts = line.split()
                    # chain score tName tSize tStrand tStart tEnd qName qSize qStrand qStart qEnd id
                    score = int(parts[1])
                    s_name, s_size, s_strand, s_start, s_end = parts[2], int(parts[3]), parts[4], int(parts[5]), int(parts[6])
                    q_name, q_size, q_strand, q_start, q_end = parts[7], int(parts[8]), parts[9], int(parts[10]), int(parts[11])
                    header = (s_name, q_name, q_strand, q_size, score)
                    s_pos, t_pos = s_start, q_start
                    continue
                if header is None:
                    continue
                parts = line.split()
                size = int(parts[0])
                s_name, q_name, q_strand, q_size, score = header
                blk = _ChainBlock(s_pos, s_pos + size, q_name, t_pos, q_strand, q_size, score)
                self.blocks.setdefault(s_name, []).append((s_pos, blk))
                if len(parts) == 3:
                    s_pos += size + int(parts[1])
                    t_pos += size + int(parts[2])
                else:
                    header = None
        for c in self.blocks:
            self.blocks[c].sort(key=lambda x: x[0])

    def lift(self, contig: str, position: int) -> Optional[Tuple[str, int, bool]]:
        """1-based position → (dest_contig, dest_position, negative_strand) or None."""
        blks = self.blocks.get(contig)
        if not blks:
            return None
        p0 = position - 1
        i = bisect.bisect_right(self._starts[contig], p0) - 1
        if i < 0:
            return None
        _, blk = blks[i]
        if not (blk.s_start <= p0 < blk.s_end):
            return None
        off = p0 - blk.s_start
        if blk.t_strand == '+':
            return blk.t_contig, blk.t_start + off + 1, False
        else:
            # target coordinates are on reverse strand: positions count from the
            # end of the target sequence
            t0 = blk.t_start + off
            return blk.t_contig, blk.t_size - t0, True
