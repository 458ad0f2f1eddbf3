"""VariantDatasetCombiner: hierarchical GVCF/VDS merging.

Capability parity with reference
`hail/python/hail/vds/combiner/variant_dataset_combiner.py:67,180-211`
(branch_factor=100, gvcf_batch_size=50 defaults; checkpointed, resumable
plan; serialized-slot equality so a saved plan round-trips through
`load_combiner` comparing equal). GVCFs are transformed to VDSes
(reference-block rows split from variant rows), merged in batches of
`branch_factor`, with the plan JSON saved after every step so a crashed run
resumes where it left off.
"""

from __future__ import annotations

import json
import math
import os
import uuid
from typing import Collection, Dict, List, NamedTuple, Optional

from .. import read_vds
from .combine import combine_variant_datasets, transform_gvcf

VDS_VERSION = 1


class VDSMetadata(NamedTuple):
    """Path to a Variant Dataset + number of samples within (reference
    variant_dataset_combiner.py:31)."""

    path: str
    n_samples: int


def calculate_even_genome_partitioning(reference_genome, interval_size):
    """Locus intervals of at most `interval_size` evenly tiling every contig
    (reference combiner/combine.py:612)."""
    from ... import genetics as _gen
    from ...utils.structs import Interval
    from ...context import get_reference
    rg = get_reference(reference_genome) if isinstance(reference_genome, str) \
        else reference_genome
    out = []
    for contig in rg.contigs:
        contig_length = rg.lengths[contig]
        n_parts = math.ceil(contig_length / interval_size)
        real_size = math.ceil(contig_length / n_parts)
        n = 1
        while n < contig_length:
            end = min(n + real_size, contig_length)
            out.append(Interval(
                _gen.Locus(contig, n, rg), _gen.Locus(contig, end, rg),
                includes_start=True, includes_end=True))
            n = end + 1
    return out


class VariantDatasetCombiner:
    """Checkpointed, resumable combiner plan (reference
    `variant_dataset_combiner.py:67`)."""

    _default_branch_factor = 100
    _default_target_records = 24_000
    _default_gvcf_batch_size = 50
    # backwards-compat spellings
    default_branch_factor = _default_branch_factor
    default_gvcf_batch_size = _default_gvcf_batch_size
    default_genome_interval_size = 1_200_000
    default_exome_interval_size = 60_000_000

    # equality + JSON round-trip are defined over these (reference :195-216)
    __serialized_slots__ = [
        '_save_path',
        '_output_path',
        '_temp_path',
        '_reference_genome',
        '_branch_factor',
        '_target_records',
        '_gvcf_batch_size',
        '_contig_recoding',
        '_vdses',
        '_gvcfs',
        '_gvcf_external_header',
        '_gvcf_sample_names',
        '_gvcf_import_intervals',
        '_gvcf_info_to_keep',
        '_gvcf_reference_entry_fields_to_keep',
        '_gvcf_save_filters',
        '_call_fields',
    ]

    def __init__(self, *, save_path: str, output_path: str, temp_path: str,
                 reference_genome='default',
                 branch_factor: int = _default_branch_factor,
                 target_records: int = _default_target_records,
                 gvcf_batch_size: int = _default_gvcf_batch_size,
                 contig_recoding: Optional[Dict[str, str]] = None,
                 call_fields: Collection[str] = (),
                 vdses: Optional[List[VDSMetadata]] = None,
                 gvcfs: Optional[List[str]] = None,
                 gvcf_sample_names: Optional[List[str]] = None,
                 gvcf_external_header: Optional[str] = None,
                 gvcf_import_intervals: Optional[list] = None,
                 gvcf_info_to_keep: Optional[Collection[str]] = None,
                 gvcf_reference_entry_fields_to_keep: Optional[Collection[str]] = None,
                 gvcf_save_filters: bool = False):
        if branch_factor < 2:
            raise ValueError(
                f"'branch_factor' must be at least 2, found {branch_factor}")
        if gvcf_batch_size < 1:
            raise ValueError(
                f"'gvcf_batch_size' must be at least 1, found {gvcf_batch_size}")
        if (gvcf_sample_names is None) != (gvcf_external_header is None):
            raise ValueError(
                "both 'gvcf_sample_names' and 'gvcf_external_header' must be "
                "set or unset")
        self._save_path = save_path
        self._output_path = output_path
        self._temp_path = temp_path
        self._reference_genome = (
            reference_genome if isinstance(reference_genome, str)
            else reference_genome.name)
        self._branch_factor = branch_factor
        self._target_records = target_records
        self._gvcf_batch_size = gvcf_batch_size
        self._contig_recoding = contig_recoding
        self._call_fields = list(call_fields)
        self._vdses = [VDSMetadata(*v) for v in (vdses or [])]
        self._gvcfs = list(gvcfs or [])
        self._gvcf_sample_names = gvcf_sample_names
        self._gvcf_external_header = gvcf_external_header
        self._gvcf_import_intervals = list(gvcf_import_intervals or [])
        self._gvcf_info_to_keep = (
            set(gvcf_info_to_keep) if gvcf_info_to_keep is not None else None)
        self._gvcf_reference_entry_fields_to_keep = (
            set(gvcf_reference_entry_fields_to_keep)
            if gvcf_reference_entry_fields_to_keep is not None else None)
        self._gvcf_save_filters = gvcf_save_filters

    # -- compatibility aliases ----------------------------------------------
    @property
    def save_path(self):
        return self._save_path

    @save_path.setter
    def save_path(self, v):
        self._save_path = v

    @property
    def output_path(self):
        return self._output_path

    @property
    def temp_path(self):
        return self._temp_path

    @property
    def reference_genome(self):
        return self._reference_genome

    @property
    def branch_factor(self):
        return self._branch_factor

    @property
    def gvcf_batch_size(self):
        """The number of GVCFs to combine into a Variant Dataset at once."""
        return self._gvcf_batch_size

    @gvcf_batch_size.setter
    def gvcf_batch_size(self, value: int):
        self._gvcf_batch_size = value

    @property
    def gvcf_paths(self):
        return self._gvcfs

    @property
    def vds_paths(self):
        return [md.path for md in self._vdses]

    def __eq__(self, other):
        if other.__class__ != VariantDatasetCombiner:
            return False
        for slot in self.__serialized_slots__:
            if getattr(self, slot) != getattr(other, slot):
                return False
        return True

    def __hash__(self):
        return hash((self._save_path, self._output_path))

    @property
    def finished(self) -> bool:
        """Have all GVCFs and input Variant Datasets been combined?"""
        return not self._gvcfs and not self._vdses

    # -- plan persistence ----------------------------------------------------
    def to_dict(self) -> dict:
        """A serializable representation (reference :389-415)."""
        from ... import types as ht
        from ...context import get_reference
        rg = get_reference(self._reference_genome)
        intervals_typ = ht.tarray(ht.tinterval(ht.tlocus(rg)))
        return {
            'name': self.__class__.__name__,
            'save_path': self._save_path,
            'output_path': self._output_path,
            'temp_path': self._temp_path,
            'reference_genome': self._reference_genome,
            'branch_factor': self._branch_factor,
            'target_records': self._target_records,
            'gvcf_batch_size': self._gvcf_batch_size,
            'gvcf_external_header': self._gvcf_external_header,
            'contig_recoding': self._contig_recoding,
            'gvcf_info_to_keep': (None if self._gvcf_info_to_keep is None
                                  else sorted(self._gvcf_info_to_keep)),
            'gvcf_reference_entry_fields_to_keep': (
                None if self._gvcf_reference_entry_fields_to_keep is None
                else sorted(self._gvcf_reference_entry_fields_to_keep)),
            'gvcf_save_filters': self._gvcf_save_filters,
            'call_fields': self._call_fields,
            'vdses': [list(md) for md in self._vdses],
            'gvcfs': self._gvcfs,
            'gvcf_sample_names': self._gvcf_sample_names,
            'gvcf_import_intervals': intervals_typ._convert_to_json(
                self._gvcf_import_intervals),
            'version': VDS_VERSION,
        }

    def save(self) -> None:
        from ...fs import local_path
        self._save_path = local_path(self._save_path)
        os.makedirs(os.path.dirname(os.path.abspath(self._save_path)) or '.',
                    exist_ok=True)
        with open(self._save_path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2)

    @staticmethod
    def load(path: str) -> 'VariantDatasetCombiner':
        from ...fs import local_path
        path = local_path(path)
        with open(path) as f:
            d = json.load(f)
        c = VariantDatasetCombiner.from_dict(d)
        if c._save_path != path:
            # reference :370-376: a moved plan file adopts its new location
            from ...utils.java import warning
            warning('path/save_path mismatch in loaded VariantDatasetCombiner, '
                    f'using {path} as the new save_path for this combiner')
            c._save_path = path
        return c

    @staticmethod
    def from_dict(d: dict) -> 'VariantDatasetCombiner':
        from ... import types as ht
        from ...context import get_reference
        rg = get_reference(d['reference_genome'])
        intervals_typ = ht.tarray(ht.tinterval(ht.tlocus(rg)))
        intervals = intervals_typ._convert_from_json(
            d.get('gvcf_import_intervals', []))
        return VariantDatasetCombiner(
            save_path=d['save_path'],
            output_path=d['output_path'],
            temp_path=d['temp_path'],
            reference_genome=d['reference_genome'],
            branch_factor=d.get('branch_factor',
                                VariantDatasetCombiner._default_branch_factor),
            target_records=d.get('target_records',
                                 VariantDatasetCombiner._default_target_records),
            gvcf_batch_size=d.get(
                'gvcf_batch_size',
                VariantDatasetCombiner._default_gvcf_batch_size),
            contig_recoding=d.get('contig_recoding'),
            call_fields=d.get('call_fields', []),
            vdses=[VDSMetadata(*x) for x in d.get('vdses', [])],
            gvcfs=d.get('gvcfs', d.get('gvcf_paths', [])),
            gvcf_sample_names=d.get('gvcf_sample_names'),
            gvcf_external_header=d.get('gvcf_external_header'),
            gvcf_import_intervals=intervals,
            gvcf_info_to_keep=d.get('gvcf_info_to_keep'),
            gvcf_reference_entry_fields_to_keep=d.get(
                'gvcf_reference_entry_fields_to_keep'),
            gvcf_save_filters=d.get('gvcf_save_filters', False))

    # -- execution -----------------------------------------------------------
    def run(self) -> None:
        from ...io.vcf import import_vcf

        def count_samples(vds) -> int:
            return vds.reference_data._stage.n_cols

        while self._gvcfs:
            batch = self._gvcfs[:self._gvcf_batch_size]
            names = (self._gvcf_sample_names[:len(batch)]
                     if self._gvcf_sample_names is not None else None)
            vdses = []
            for i, p in enumerate(batch):
                mt = import_vcf(p, reference_genome=self._reference_genome,
                                contig_recoding=self._contig_recoding,
                                header_file=self._gvcf_external_header,
                                call_fields=self._call_fields,
                                force_bgz=True, array_elements_required=False)
                if names is not None:
                    mt = _rename_sample(mt, names[i])
                if self._gvcf_import_intervals:
                    mt = _filter_rows_to_intervals(mt, self._gvcf_import_intervals)
                vdses.append(transform_gvcf(
                    mt,
                    reference_entry_fields_to_keep=(
                        self._gvcf_reference_entry_fields_to_keep or ()),
                    info_to_keep=self._gvcf_info_to_keep,
                    save_filters=self._gvcf_save_filters))
            merged = combine_variant_datasets(vdses)
            tmp = os.path.join(self._temp_path,
                               f'combine_{uuid.uuid4().hex[:8]}.vds')
            merged.write(tmp, overwrite=True)
            self._vdses.append(VDSMetadata(tmp, count_samples(merged)))
            self._gvcfs = self._gvcfs[len(batch):]
            if self._gvcf_sample_names is not None:
                self._gvcf_sample_names = self._gvcf_sample_names[len(batch):]
            self.save()
        while len(self._vdses) > 1:
            batch = self._vdses[:self._branch_factor]
            vdses = [read_vds(md.path) for md in batch]
            merged = combine_variant_datasets(vdses)
            tmp = os.path.join(self._temp_path,
                               f'combine_{uuid.uuid4().hex[:8]}.vds')
            merged.write(tmp, overwrite=True)
            self._vdses = [VDSMetadata(tmp, count_samples(merged))] \
                + self._vdses[len(batch):]
            self.save()
        if self._vdses:
            final = read_vds(self._vdses[0].path)
            self._write_final(final)
        self._vdses = []
        self.save()

    def _write_final(self, vds) -> None:
        from .. import VariantDataset, store_ref_block_max_length
        vds.write(self._output_path, overwrite=True)
        if VariantDataset.ref_block_max_length_field not in vds.reference_data.globals:
            # reference :436-441: compute + store post-hoc
            store_ref_block_max_length(self._output_path)


def _filter_rows_to_intervals(mt, intervals):
    """Restrict an imported GVCF to the import intervals (the reference uses
    the intervals as read partitions, LoadVCF.scala GVCF partition reader)."""
    from ...methods.misc import filter_intervals
    return filter_intervals(mt, intervals, keep=True)


def _rename_sample(mt, name: str):
    from ...expr import functions as F
    return mt.key_cols_by(s=F.literal(name))


def new_combiner(*, output_path: str, temp_path: str,
                 save_path: Optional[str] = None,
                 gvcf_paths: Optional[List[str]] = None,
                 vds_paths: Optional[List[str]] = None,
                 vds_sample_counts: Optional[List[int]] = None,
                 intervals: Optional[list] = None,
                 import_interval_size: Optional[int] = None,
                 use_genome_default_intervals: bool = False,
                 use_exome_default_intervals: bool = False,
                 gvcf_external_header: Optional[str] = None,
                 gvcf_sample_names: Optional[List[str]] = None,
                 gvcf_info_to_keep: Optional[Collection[str]] = None,
                 gvcf_reference_entry_fields_to_keep: Optional[Collection[str]] = None,
                 gvcf_save_filters: bool = False,
                 call_fields: Collection[str] = ('PGT',),
                 branch_factor: int = VariantDatasetCombiner._default_branch_factor,
                 target_records: int = VariantDatasetCombiner._default_target_records,
                 gvcf_batch_size: Optional[int] = None,
                 batch_size: Optional[int] = None,
                 reference_genome='default',
                 contig_recoding: Optional[Dict[str, str]] = None,
                 force: bool = False, **kwargs) -> VariantDatasetCombiner:
    """Create a new combiner plan or resume one saved at `save_path`
    (reference variant_dataset_combiner.py:652)."""
    if not (gvcf_paths or vds_paths):
        raise ValueError(
            "at least one of 'gvcf_paths' or 'vds_paths' must be nonempty")
    gvcf_paths = list(gvcf_paths or [])
    vds_paths = list(vds_paths or [])
    if gvcf_paths and len(set(gvcf_paths)) != len(gvcf_paths):
        raise ValueError('gvcf paths should be unique')
    if (gvcf_sample_names is None) != (gvcf_external_header is None):
        raise ValueError(
            "both 'gvcf_sample_names' and 'gvcf_external_header' must be set "
            "or unset")
    if gvcf_sample_names is not None and len(gvcf_sample_names) != len(gvcf_paths):
        raise ValueError(
            "'gvcf_sample_names' and 'gvcf_paths' must have the same length "
            f'{len(gvcf_sample_names)} != {len(gvcf_paths)}')
    if batch_size is None:
        if gvcf_batch_size is None:
            gvcf_batch_size = VariantDatasetCombiner._default_gvcf_batch_size
    elif gvcf_batch_size is None:
        gvcf_batch_size = batch_size
    else:
        raise ValueError(
            'Specify only one of batch_size and gvcf_batch_size. '
            f'Received {batch_size} and {gvcf_batch_size}.')

    if save_path is None:
        # content-hashed plan name (reference :879-906) so combiners sharing
        # a temp dir don't collide
        import hashlib
        sha = hashlib.sha256()
        sha.update(output_path.encode())
        sha.update(temp_path.encode())
        sha.update(str(reference_genome).encode())
        for path in vds_paths:
            sha.update(path.encode())
        for path in gvcf_paths:
            sha.update(path.encode())
        if gvcf_external_header is not None:
            sha.update(gvcf_external_header.encode())
        if gvcf_sample_names is not None:
            for name in gvcf_sample_names:
                sha.update(name.encode())
        if gvcf_info_to_keep is not None:
            for kept_info in sorted(gvcf_info_to_keep):
                sha.update(kept_info.encode())
        if gvcf_reference_entry_fields_to_keep is not None:
            for field in sorted(gvcf_reference_entry_fields_to_keep):
                sha.update(field.encode())
        sha.update(b'\1' if gvcf_save_filters else b'\0')
        for call_field in sorted(call_fields):
            sha.update(call_field.encode())
        save_path = os.path.join(
            temp_path, f'vds-combiner-plan_{sha.hexdigest()}_{VDS_VERSION}.json')
    if os.path.exists(save_path) and not force:
        try:
            c = VariantDatasetCombiner.load(save_path)
        except (ValueError, TypeError, OSError, KeyError):
            c = None
        if c is not None:
            # resumable knobs may be overridden on resume (reference :745-750)
            c._branch_factor = branch_factor
            c._target_records = target_records
            c._gvcf_batch_size = gvcf_batch_size
            return c

    if gvcf_paths:
        n_partition_args = (int(intervals is not None)
                            + int(import_interval_size is not None)
                            + int(use_genome_default_intervals)
                            + int(use_exome_default_intervals))
        if n_partition_args == 0:
            raise ValueError(
                "'new_combiner': require one argument from 'intervals', "
                "'import_interval_size', 'use_genome_default_intervals', or "
                "'use_exome_default_intervals' to choose GVCF partitioning")
        if intervals is not None:
            pass
        elif import_interval_size is not None:
            intervals = calculate_even_genome_partitioning(
                reference_genome, import_interval_size)
        elif use_genome_default_intervals:
            intervals = calculate_even_genome_partitioning(
                reference_genome,
                VariantDatasetCombiner.default_genome_interval_size)
        elif use_exome_default_intervals:
            intervals = calculate_even_genome_partitioning(
                reference_genome,
                VariantDatasetCombiner.default_exome_interval_size)
    else:
        intervals = []

    vdses = [VDSMetadata(p, vds_sample_counts[i] if vds_sample_counts else -1)
             for i, p in enumerate(vds_paths)]
    c = VariantDatasetCombiner(
        save_path=save_path, output_path=output_path, temp_path=temp_path,
        reference_genome=reference_genome, branch_factor=branch_factor,
        target_records=target_records, gvcf_batch_size=gvcf_batch_size,
        contig_recoding=contig_recoding, call_fields=call_fields,
        vdses=vdses, gvcfs=gvcf_paths,
        gvcf_sample_names=gvcf_sample_names,
        gvcf_external_header=gvcf_external_header,
        gvcf_import_intervals=intervals or [],
        gvcf_info_to_keep=gvcf_info_to_keep,
        gvcf_reference_entry_fields_to_keep=gvcf_reference_entry_fields_to_keep,
        gvcf_save_filters=gvcf_save_filters)
    c.save()
    return c


def load_combiner(path: str) -> VariantDatasetCombiner:
    return VariantDatasetCombiner.load(path)
