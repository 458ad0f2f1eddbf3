"""Batch REST front end (reference `batch/front_end/front_end.py`).

Serves the /api/v1alpha surface the reference `hailtop.batch_client`
exercises — batch/update/job-group/job CRUD with the reference's JSON
shapes (`batch/batch/batch.py` batch_record_to_dict / job_record_to_dict),
create-payload validation (`front_end/validate.py` keysets), the v1/v2
query languages for batch and job listing, billing-project administration,
and region/cloud introspection. State lives in sqlite (service.py _DB);
scheduling/cancel logic lives in driver.py.

Semantics matched to the reference:
  * batch create is token-idempotent; n_jobs reserves update #1's job-id
    block; updates allocate disjoint id blocks and jobs become visible when
    the update commits.
  * the REST state of a batch is derived: open | failure | cancelled |
    success | running (batch_record_to_dict, batch.py:27-38).
  * `MAX_JOB_GROUPS_DEPTH` (= 2, batch_client.globals) bounds group nesting.
"""

from __future__ import annotations

import json
import secrets
import time
from typing import Any, Dict, List, Optional

from aiohttp import web

TERMINAL = ('Success', 'Failed', 'Cancelled', 'Error')
ROOT_JOB_GROUP_ID = 0
MAX_JOB_GROUPS_DEPTH = 2
MAX_BUNCH_BYTESIZE = 1024 * 1024
MAX_BUNCH_SIZE = 1024


def _now_ms() -> int:
    return int(time.time() * 1000)


def _time_str(t: Optional[int]) -> Optional[str]:
    if t is None:
        return None
    import datetime
    return (datetime.datetime.fromtimestamp(t / 1000, datetime.timezone.utc)
            .strftime('%Y-%m-%dT%H:%M:%SZ'))


# per-core-hour flat rate (the reference prices from cloud billing tables)
CORE_HOUR_RATE = 0.01


def _cost_of_ms(duration_ms: Optional[int]) -> float:
    if not duration_ms:
        return 0.0
    return round(duration_ms / 3_600_000 * CORE_HOUR_RATE, 10)


# ---------------------------------------------------------------------------
# validation (reference front_end/validate.py)
# ---------------------------------------------------------------------------

class ValidationError(Exception):
    pass


_BATCH_KEYS = {'attributes', 'billing_project', 'callback', 'n_jobs',
               'n_job_groups', 'token', 'cancel_after_n_failures'}
_UPDATE_KEYS = {'token', 'n_jobs', 'n_job_groups'}
_JOB_KEYS = {'always_copy_output', 'always_run', 'attributes', 'env',
             'cloudfuse', 'input_files', 'job_id', 'mount_tokens', 'network',
             'n_max_attempts', 'unconfined', 'output_files', 'parent_ids',
             'absolute_parent_ids', 'in_update_parent_ids',
             'absolute_job_group_id', 'in_update_job_group_id', 'port',
             'process', 'regions', 'requester_pays_project', 'resources',
             'secrets', 'service_account', 'timeout', 'user_code'}
_JOB_GROUP_KEYS = {'job_group_id', 'attributes', 'callback',
                   'cancel_after_n_failures', 'absolute_parent_id',
                   'in_update_parent_id'}


def validate_batch(spec: Any) -> None:
    if not isinstance(spec, dict):
        raise ValidationError('batch spec must be a dict')
    unknown = set(spec) - _BATCH_KEYS
    if unknown:
        raise ValidationError(f'unknown keys in batch spec: {sorted(unknown)}')
    bp = spec.get('billing_project')
    if not isinstance(bp, str):
        raise ValidationError('billing_project is required and must be str')
    n_jobs = spec.get('n_jobs')
    if not isinstance(n_jobs, int) or isinstance(n_jobs, bool):
        raise ValidationError('n_jobs is required and must be int')
    token = spec.get('token')
    if not isinstance(token, str):
        raise ValidationError('token is required and must be str')
    attrs = spec.get('attributes')
    if attrs is not None:
        if not isinstance(attrs, dict) or any(
                not isinstance(k, str) or not isinstance(v, str)
                for k, v in attrs.items()):
            raise ValidationError('attributes must be dict[str, str]')
    cb = spec.get('callback')
    if cb is not None and not isinstance(cb, str):
        raise ValidationError('callback must be str')
    canf = spec.get('cancel_after_n_failures')
    if canf is not None and (not isinstance(canf, int)
                             or isinstance(canf, bool) or canf <= 0):
        raise ValidationError('cancel_after_n_failures must be int > 0')
    njg = spec.get('n_job_groups')
    if njg is not None and (not isinstance(njg, int) or isinstance(njg, bool)):
        raise ValidationError('n_job_groups must be int')


def validate_update(spec: Any) -> None:
    if not isinstance(spec, dict):
        raise ValidationError('update spec must be a dict')
    unknown = set(spec) - _UPDATE_KEYS
    if unknown:
        raise ValidationError(f'unknown keys in update spec: {sorted(unknown)}')
    if not isinstance(spec.get('token'), str):
        raise ValidationError('token is required and must be str')
    n_jobs = spec.get('n_jobs')
    if not isinstance(n_jobs, int) or isinstance(n_jobs, bool) or n_jobs < 0:
        raise ValidationError('n_jobs is required and must be int >= 0')


# single-node "machine shapes" for satisfiability checks (the reference
# checks requests against its cloud worker types, front_end.py:1200-1270)
_MEMORY_TYPES = ('lowmem', 'standard', 'highmem')
_MEM_PER_CORE = {'lowmem': 1 * 1024**3, 'standard': 3.75 * 1024**3,
                 'highmem': 7.5 * 1024**3}
_MAX_CORES = 16
_MAX_STORAGE_BYTES = 5 * 1024**4          # 5 Ti per job
_VALID_CPUS_MCPU = {250, 500, 1000, 2000, 4000, 8000, 16000}


def validate_job_resources(jid: Any, resources: Any) -> None:
    # the alias package's parsers, copied here: `hailtop` imports jax
    from .parse import (
        CPU_REGEX, MEMORY_REGEX, STORAGE_REGEX, parse_cpu_in_mcpu,
        parse_memory_in_bytes, parse_storage_in_bytes)
    if not isinstance(resources, dict):
        raise ValidationError(f'jobs[{jid}].resources is not a dict')
    cpu = resources.get('cpu')
    mcpu = 1000
    if cpu is not None:
        if not isinstance(cpu, str) or not CPU_REGEX.fullmatch(cpu):
            raise ValidationError(
                f'jobs[{jid}].resources.cpu must match regex: '
                f'{CPU_REGEX.pattern}')
        mcpu = parse_cpu_in_mcpu(cpu)
        if mcpu not in _VALID_CPUS_MCPU:
            raise ValidationError(
                f'bad resource request for job {jid}: cpu must be a power '
                f'of two with a min of 0.25; found {cpu}')
    memory = resources.get('memory')
    mem_bytes = None
    if memory is not None:
        if not isinstance(memory, str) or not (
                MEMORY_REGEX.fullmatch(memory) or memory in _MEMORY_TYPES):
            raise ValidationError(
                f'jobs[{jid}].resources.memory must match regex: '
                f'{MEMORY_REGEX.pattern}; '
                f'jobs[{jid}].resources.memory must be one of: '
                f'{" ".join(_MEMORY_TYPES)}')
        if memory not in _MEMORY_TYPES:
            mem_bytes = parse_memory_in_bytes(memory)
    storage = resources.get('storage')
    storage_bytes = None
    if storage is not None:
        if not isinstance(storage, str) or not STORAGE_REGEX.fullmatch(storage):
            raise ValidationError(
                f'jobs[{jid}].resources.storage must match regex: '
                f'{STORAGE_REGEX.pattern}')
        storage_bytes = parse_storage_in_bytes(storage)
    # satisfiability vs the biggest machine shape available
    problems = []
    if mem_bytes is not None:
        cores = mcpu / 1000
        if mem_bytes > cores * max(_MEM_PER_CORE.values()):
            problems.append(f'memory {memory} at {cpu or "1"} cpu exceeds '
                            'every worker shape')
    if storage_bytes is not None and storage_bytes > _MAX_STORAGE_BYTES:
        problems.append(f'storage {storage} exceeds the maximum disk size')
    if problems:
        raise ValidationError(
            f'resource requests for job {jid} are unsatisfiable: '
            + '; '.join(problems))


def validate_job(spec: Any) -> None:
    if not isinstance(spec, dict):
        raise ValidationError('job spec must be a dict')
    unknown = set(spec) - _JOB_KEYS - {'spec', 'command',
                                       'job_group_id'}      # legacy internal
    if unknown:
        raise ValidationError(f'unknown keys in job spec: {sorted(unknown)}')
    if not isinstance(spec.get('job_id'), int):
        raise ValidationError('job_id is required and must be int')
    process = spec.get('process')
    if process is not None:
        if not isinstance(process, dict):
            raise ValidationError('process must be a dict')
        if process.pop('mount_docker_socket', False):
            raise ValidationError(
                'mount_docker_socket is no longer supported but was set to '
                'True in request. Please upgrade.')
        typ = process.get('type')
        if typ == 'docker':
            if not isinstance(process.get('command'), list):
                raise ValidationError('process.command must be a list')
            if not isinstance(process.get('image'), str):
                raise ValidationError('process.image must be str')
        elif typ == 'jvm':
            if not isinstance(process.get('command'), list):
                raise ValidationError('process.command must be a list')
        elif typ is None and 'command' in process:
            pass    # legacy internal shape: bare {'command': ...}
        else:
            raise ValidationError(f'unknown process type {typ!r}')
    if spec.get('resources') is not None:
        validate_job_resources(spec['job_id'], spec['resources'])
    parents = (spec.get('parent_ids') or spec.get('absolute_parent_ids')
               or spec.get('in_update_parent_ids'))
    if parents is not None and len(parents) != len(set(parents)):
        raise ValidationError(
            f'jobs[{spec["job_id"]}] has duplicated parent ids: {parents}')
    attrs = spec.get('attributes')
    if attrs is not None:
        if not isinstance(attrs, dict):
            raise ValidationError('attributes is not a dict')
        for k, v in attrs.items():
            if not isinstance(v, str):
                raise ValidationError(
                    f"jobs[{spec.get('job_id')}].attributes.{k} "
                    f"is not {str}")
    timeout = spec.get('timeout')
    if timeout is not None and (not isinstance(timeout, (int, float))
                                or timeout <= 0):
        raise ValidationError('timeout must be numeric > 0')
    for fkey in ('input_files', 'output_files'):
        files = spec.get(fkey)
        if files is not None:
            if not isinstance(files, list) or any(
                    not isinstance(f, dict) or 'from' not in f or 'to' not in f
                    for f in files):
                raise ValidationError(f'{fkey} must be a list of {{from, to}}')


def validate_job_group(spec: Any) -> None:
    if not isinstance(spec, dict):
        raise ValidationError('job group spec must be a dict')
    unknown = set(spec) - _JOB_GROUP_KEYS
    if unknown:
        raise ValidationError(
            f'unknown keys in job group spec: {sorted(unknown)}')
    if not isinstance(spec.get('job_group_id'), int):
        raise ValidationError('job_group_id is required and must be int')
    canf = spec.get('cancel_after_n_failures')
    if canf is not None and (not isinstance(canf, int) or canf <= 0):
        raise ValidationError('cancel_after_n_failures must be int > 0')
    attrs = spec.get('attributes')
    if attrs is not None:
        if not isinstance(attrs, dict):
            raise ValidationError('job group attributes is not a dict')
        for k, v in attrs.items():
            if not isinstance(v, str):
                raise ValidationError(
                    f"job_groups[{spec.get('job_group_id')}]"
                    f".attributes.{k} is not {str}")


# ---------------------------------------------------------------------------
# status dict builders (reference batch/batch/batch.py)
# ---------------------------------------------------------------------------

def _batch_counts(db, bid: int) -> Dict[str, int]:
    counts = {s: 0 for s in ('Pending', 'Ready', 'Running', 'Success',
                             'Failed', 'Cancelled', 'Error')}
    for r in db.query(
            'SELECT state, COUNT(*) c FROM jobs WHERE batch_id = ? AND '
            'committed = 1 GROUP BY state', (bid,)):
        counts[r['state']] = r['c']
    return counts


def batch_status_dict(db, bid: int) -> dict:
    rows = db.query('SELECT * FROM batches WHERE id = ?', (bid,))
    if not rows:
        raise web.HTTPNotFound(reason=f'batch {bid} not found')
    b = rows[0]
    counts = _batch_counts(db, bid)
    n_done = sum(counts[s] for s in TERMINAL)
    n_failed = counts['Failed'] + counts['Error']
    complete = b['state'] in ('complete', 'cancelled') \
        and b['n_jobs'] == n_done
    if b['state'] == 'open':
        state = 'open'
    elif n_failed > 0:
        state = 'failure'
    elif b['cancelled'] or counts['Cancelled'] > 0:
        state = 'cancelled'
    elif b['state'] == 'complete':
        state = 'success'
    else:
        state = 'running'
    dur = db.query(
        'SELECT SUM(duration_ms) s FROM jobs WHERE batch_id = ?', (bid,))
    msec_mcpu = int(dur[0]['s'] or 0) * 1000
    duration_ms = None
    if b['time_created'] is not None and b['time_completed'] is not None:
        duration_ms = b['time_completed'] - b['time_created']
    out = {
        'id': b['id'],
        'user': b['user'],
        'billing_project': b['billing_project'],
        'token': b['token'],
        'state': state,
        'complete': complete,
        'closed': b['state'] != 'open',
        'n_jobs': b['n_jobs'],
        'n_completed': n_done,
        'n_succeeded': counts['Success'],
        'n_failed': n_failed,
        'n_cancelled': counts['Cancelled'],
        'time_created': _time_str(b['time_created']),
        'time_closed': _time_str(b['time_closed']),
        'time_completed': _time_str(b['time_completed']),
        'duration_ms': duration_ms,
        'duration': (f'{duration_ms // 1000}s'
                     if duration_ms is not None else None),
        'msec_mcpu': msec_mcpu,
        'cost': _cost_of_ms(int(dur[0]['s'] or 0)),
        'cost_breakdown': [{'resource': 'compute/core-hours',
                            'cost': _cost_of_ms(int(dur[0]['s'] or 0))}],
    }
    attributes = json.loads(b['attributes'])
    if attributes:
        out['attributes'] = attributes
    return out


def _descendant_groups(db, bid: int, gid: int) -> List[int]:
    children: Dict[Optional[int], List[int]] = {}
    for r in db.query('SELECT job_group_id, parent_id FROM job_groups '
                      'WHERE batch_id = ?', (bid,)):
        children.setdefault(r['parent_id'], []).append(r['job_group_id'])
    out, stack = [], [gid]
    while stack:
        g = stack.pop()
        out.append(g)
        stack.extend(children.get(g, []))
    return out


def job_group_status_dict(db, bid: int, gid: int) -> dict:
    rows = db.query('SELECT * FROM job_groups WHERE batch_id = ? AND '
                    'job_group_id = ?', (bid, gid))
    if not rows:
        raise web.HTTPNotFound(reason=f'job group {bid}/{gid} not found')
    g = rows[0]
    b = db.query('SELECT * FROM batches WHERE id = ?', (bid,))[0]
    gids = _descendant_groups(db, bid, gid)
    qmarks = ','.join('?' * len(gids))
    counts = {s: 0 for s in ('Pending', 'Ready', 'Running', 'Success',
                             'Failed', 'Cancelled', 'Error')}
    dur_total = 0
    for r in db.query(
            f'SELECT state, COUNT(*) c, SUM(duration_ms) s FROM jobs '
            f'WHERE batch_id = ? AND committed = 1 AND job_group_id IN '
            f'({qmarks}) GROUP BY state', (bid, *gids)):
        counts[r['state']] = r['c']
        dur_total += int(r['s'] or 0)
    n_jobs = sum(counts.values())
    n_done = sum(counts[s] for s in TERMINAL)
    n_failed = counts['Failed'] + counts['Error']
    complete = b['state'] != 'open' and n_done == n_jobs
    if n_failed > 0:
        state = 'failure'
    elif g['cancelled'] or counts['Cancelled'] > 0:
        state = 'cancelled'
    elif complete and n_jobs > 0:
        state = 'success'
    else:
        state = 'running'
    duration_ms = None
    if g['time_created'] is not None and g['time_completed'] is not None:
        duration_ms = g['time_completed'] - g['time_created']
    out = {
        'batch_id': bid,
        'job_group_id': gid,
        'state': state,
        'complete': complete,
        'n_jobs': n_jobs,
        'n_completed': n_done,
        'n_succeeded': counts['Success'],
        'n_failed': n_failed,
        'n_cancelled': counts['Cancelled'],
        'time_created': _time_str(g['time_created']),
        'time_completed': _time_str(g['time_completed']),
        'duration': duration_ms,
        'cost': _cost_of_ms(dur_total),
        'cost_breakdown': [{'resource': 'compute/core-hours',
                            'cost': _cost_of_ms(dur_total)}],
    }
    attributes = json.loads(g['attributes'])
    if attributes:
        out['attributes'] = attributes
    return out


def _spec_attributes(spec: dict) -> dict:
    return (spec.get('attributes')
            or (spec.get('process') or {}).get('attributes')
            or {})


def job_list_entry(db, r, user: str, billing_project: str) -> dict:
    spec = json.loads(r['spec'])
    attributes = _spec_attributes(spec)
    return {
        'batch_id': r['batch_id'],
        'job_id': r['job_id'],
        'name': attributes.get('name'),
        'user': user,
        'billing_project': billing_project,
        'state': r['state'],
        'exit_code': r['exit_code'],
        'end_time': _time_str(r['time_completed']),
        'duration': r['duration_ms'],
        'cost': _cost_of_ms(r['duration_ms']),
        'msec_mcpu': int(r['duration_ms'] or 0) * 1000,
        'cost_breakdown': [{'resource': 'compute/core-hours',
                            'cost': _cost_of_ms(r['duration_ms'])}],
        'always_run': bool(r['always_run']),
        'display_state': None,
        # extra fields beyond the reference list entry (internal clients)
        'attempts': r['attempts'],
        'error': r['error'],
        'job_group_id': r['job_group_id'],
    }


def full_job_dict(db, r, user: str, billing_project: str) -> dict:
    out = job_list_entry(db, r, user, billing_project)
    spec = json.loads(r['spec'])
    status = json.loads(r['status']) if r['status'] else None
    if status is not None:
        status = {
            'version': 1,
            'worker': 'batch-worker-0',
            'batch_id': r['batch_id'],
            'job_id': r['job_id'],
            'attempt_id': r['attempts'],
            'user': user,
            'state': r['state'],
            'format_version': 6,
            'resources': spec.get('resources') or {},
            'region': 'local',
            'container_statuses': status.get('container_statuses'),
            'error': status.get('error'),
        }
    out['status'] = status
    out['spec'] = spec
    attributes = _spec_attributes(spec)
    if attributes:
        out['attributes'] = attributes
    return out


# ---------------------------------------------------------------------------
# query languages (reference batch/front_end/query/)
# ---------------------------------------------------------------------------

_JOB_STATE_TERMS = {
    'pending': {'pending'}, 'ready': {'ready'}, 'creating': {'creating'},
    'running': {'running'},
    'live': {'ready', 'creating', 'running'},
    'cancelled': {'cancelled'}, 'error': {'error'}, 'failed': {'failed'},
    'bad': {'error', 'failed'},
    'success': {'success'},
    'done': {'cancelled', 'error', 'failed', 'success'},
}

_V2_OPS = ('!~', '=~', '>=', '<=', '!=', '==', '>', '<', '=')


def _split_v2_statement(term: str):
    """`left op right` with optional spaces (reference pad_maybe_operator);
    a multi-token line with no recognized operator is a parse error."""
    parts = term.split()
    if len(parts) == 3 and parts[1] in _V2_OPS:
        return parts[0], parts[1], parts[2]
    if len(parts) == 1:
        for op in _V2_OPS:
            if op in parts[0]:
                left, _, right = parts[0].partition(op)
                if left and right:
                    return left, op, right
        return None
    # e.g. "state != success" already covered; "tag =~ fo" covered; else:
    if len(parts) == 2:
        for op in _V2_OPS:
            if parts[0].endswith(op):
                return parts[0][:-len(op)], op, parts[1]
            if parts[1].startswith(op):
                return parts[0], op, parts[1][len(op):]
    raise web.HTTPBadRequest(reason=f'could not parse term "{term}"')


def _q_int(word: str) -> int:
    try:
        return int(word)
    except ValueError:
        raise web.HTTPBadRequest(
            reason=f'expected int, but found {word}')


def _q_float(word: str) -> float:
    try:
        return float(word)
    except ValueError:
        raise web.HTTPBadRequest(
            reason=f'expected float, but found {word}')


def _parse_time_ms(v: str) -> Optional[float]:
    import datetime
    try:
        return datetime.datetime.fromisoformat(
            v.replace('Z', '+00:00')).timestamp() * 1000
    except ValueError:
        return None


def _q_date(word: str) -> float:
    t = _parse_time_ms(word)
    if t is None:
        raise web.HTTPBadRequest(
            reason=f'expected date, but found {word}')
    return t


_EXACT_OPS = ('=', '==', '!=')
_MATCH_OPS = ('=', '==', '!=', '=~', '!~')


def _require_op(op: str, allowed, kind: str) -> None:
    if op not in allowed:
        raise web.HTTPBadRequest(
            reason=f'unexpected operator "{op}" expected one of '
                   f'{kind} operators {list(allowed)}')


def _str_match(op: str, actual, value: str) -> bool:
    _require_op(op, _MATCH_OPS, 'match')
    if actual is None:
        return False
    if op in ('=', '=='):
        return actual == value
    if op == '!=':
        return actual != value
    if op == '=~':
        return value in actual
    return value not in actual


def _cmp(op: str, actual, value) -> bool:
    if actual is None:
        return False
    if op in ('=', '=='):
        return actual == value
    if op == '!=':
        return actual != value
    if op == '>':
        return actual > value
    if op == '>=':
        return actual >= value
    if op == '<':
        return actual < value
    if op == '<=':
        return actual <= value
    raise ValueError(op)


def _attr_term(attributes: dict, k: str, op: str, v: str) -> bool:
    """Attribute keyword term (reference JobKeywordQuery): the key must
    exist; =/== exact, != not-equal, =~ contains, !~ not-contains."""
    _require_op(op, _MATCH_OPS, 'match')
    actual = attributes.get(k)
    if actual is None:
        return False
    if op in ('=', '=='):
        return actual == v
    if op == '!=':
        return actual != v
    if op == '=~':
        return v in actual
    if op == '!~':
        return v not in actual
    return False


def _terms_of(q: str, version: int) -> List[str]:
    if version >= 2:
        return [t.strip() for t in q.split('\n') if t.strip()]
    return [t for t in q.split() if t]


def batch_matches_query(status: dict, q: Optional[str],
                        version: int = 1) -> bool:
    """Scoped analogue of the reference's list-batches query languages
    (batch/front_end/query/query_v{1,2}.py), evaluated in-memory."""
    if not q:
        return True
    attributes = status.get('attributes') or {}

    def state_term(t: str) -> bool:
        if t == 'open':
            return status['state'] == 'open'
        if t == 'closed':
            return status['state'] != 'open'
        if t == 'complete':
            return bool(status['complete'])
        if t == 'running':
            return status['state'] == 'running'
        if t == 'cancelled':
            return status['state'] == 'cancelled'
        if t == 'failure':
            return status['n_failed'] > 0
        if t == 'success':
            return (bool(status['complete'])
                    and status['n_succeeded'] == status['n_jobs'])
        raise web.HTTPBadRequest(reason=f'unknown state "{t}"')

    for term in _terms_of(q, version):
        if version == 1:
            neg = term.startswith('!')
            if neg:
                term = term[1:]
            if term.startswith('has:'):
                ok = term[4:] in attributes
            elif term.startswith('user:'):
                ok = status.get('user') == term[5:]
            elif term.startswith('billing_project:'):
                ok = status.get('billing_project') == term[16:]
            elif '=' in term:
                k, _, v = term.partition('=')
                ok = attributes.get(k) == v
            elif term in ('open', 'closed', 'complete', 'running',
                          'cancelled', 'failure', 'success'):
                ok = state_term(term)
            else:
                raise web.HTTPBadRequest(
                    reason=f'Invalid search term: {term}.')
            if ok == neg:
                return False
            continue
        # v2 grammar
        stmt = _split_v2_statement(term)
        if stmt is None:
            word = term.strip()
            if word.startswith('"') and word.endswith('"') and len(word) > 1:
                w = word[1:-1]
                ok = any(w == k or w == v for k, v in attributes.items())
            else:
                ok = any(word in k or word in (v or '')
                         for k, v in attributes.items())
        else:
            left, op, right = stmt
            if left == 'batch_id':
                ok = _cmp(op, status['id'], _q_int(right))
            elif left == 'user':
                ok = _str_match(op, status.get('user'), right)
            elif left == 'billing_project':
                ok = _str_match(op, status.get('billing_project'), right)
            elif left == 'state':
                _require_op(op, _EXACT_OPS, 'exact match')
                base = state_term(right)
                ok = (not base) if op == '!=' else base
            elif left in ('start_time', 'end_time'):
                t = _q_date(right)
                key = ('time_created' if left == 'start_time'
                       else 'time_completed')
                iso = status.get(key)
                actual = _parse_time_ms(iso) if iso else None
                ok = _cmp(op, actual, t)
            elif left == 'duration':
                ok = _cmp(op, status.get('duration_ms'), _q_float(right) * 1000)
            elif left == 'cost':
                ok = _cmp(op, status.get('cost'), _q_float(right))
            else:
                ok = _attr_term(attributes, left, op, right)
        if not ok:
            return False
    return True


def job_matches_query(entry: dict, spec: dict, q: Optional[str],
                      version: int = 1) -> bool:
    """Scoped analogue of the reference's list-jobs query languages."""
    if not q:
        return True
    attributes = _spec_attributes(spec)
    state = entry['state'].lower()
    for term in _terms_of(q, version):
        if version == 1:
            neg = term.startswith('!')
            if neg:
                term = term[1:]
            if term.startswith('has:'):
                ok = term[4:] in attributes
            elif '=' in term:
                k, _, v = term.partition('=')
                if k == 'job_id':
                    ok = entry['job_id'] == int(v)
                else:
                    ok = attributes.get(k) == v
            elif term.lower() in _JOB_STATE_TERMS:
                ok = state in _JOB_STATE_TERMS[term.lower()]
            else:
                raise web.HTTPBadRequest(
                    reason=f'Invalid search term: {term}.')
            if ok == neg:
                return False
            continue
        # v2 grammar
        stmt = _split_v2_statement(term)
        if stmt is None:
            word = term.strip()
            if word.startswith('"') and word.endswith('"') and len(word) > 1:
                w = word[1:-1]
                ok = any(w == k or w == v for k, v in attributes.items())
            else:
                ok = any(word in k or word in (v or '')
                         for k, v in attributes.items())
        else:
            left, op, right = stmt
            if left == 'job_id':
                ok = _cmp(op, entry['job_id'], _q_int(right))
            elif left == 'state':
                _require_op(op, _EXACT_OPS, 'exact match')
                if right.lower() not in _JOB_STATE_TERMS:
                    raise web.HTTPBadRequest(
                        reason=f'unknown state "{right}"')
                base = state in _JOB_STATE_TERMS[right.lower()]
                ok = (not base) if op == '!=' else base
            elif left == 'instance':
                ok = _str_match(op, 'batch-worker-0', right)
            elif left == 'instance_collection':
                ok = _str_match(op, 'standard', right)
            elif left in ('start_time', 'end_time'):
                t = _q_date(right)
                if left == 'start_time':
                    actual = entry.get('_time_started_ms')
                else:
                    iso = entry.get('end_time')
                    actual = _parse_time_ms(iso) if iso else None
                ok = _cmp(op, actual, t)
            elif left == 'duration':
                ok = _cmp(op, entry.get('duration'), _q_float(right))
            elif left == 'cost':
                ok = _cmp(op, entry.get('cost'), _q_float(right))
            elif left == 'exit_code':
                ok = _cmp(op, entry.get('exit_code'), _q_int(right))
            else:
                ok = _attr_term(attributes, left, op, right)
        if not ok:
            return False
    return True


# ---------------------------------------------------------------------------
# the aiohttp application
# ---------------------------------------------------------------------------

class FrontEnd:
    """Route handlers over (_DB, Driver). BatchService (service.py) wires
    this to a TCPSite; handlers mirror reference front_end.py routes."""

    PAGE_SIZE = 50

    def __init__(self, db, driver, auth_url: Optional[str] = None,
                 default_user: str = 'test'):
        self.db = db
        self.driver = driver
        self.auth_url = auth_url.rstrip('/') if auth_url else None
        self.default_user = default_user

    # -- app ----------------------------------------------------------------
    def build_app(self) -> web.Application:
        from ..services.metrics import monitor_endpoints_middleware
        middlewares = [monitor_endpoints_middleware(),
                       self._auth_middleware()]
        app = web.Application(middlewares=middlewares,
                              client_max_size=64 * 1024 * 1024)
        r = app.router
        r.add_get('/healthcheck', self._healthcheck)
        r.add_get('/check_invariants', self._check_invariants)
        r.add_get('/metrics', self._metrics)
        r.add_get('/batches', self._ui_batches)
        r.add_get('/batches/{batch_id}', self._ui_batch)
        r.add_get('/batches/{batch_id}/jobs/{job_id}', self._ui_job)
        r.add_post('/batches/{batch_id}/cancel', self._ui_cancel_batch)
        r.add_get('/login', self._ui_login)
        r.add_get('/api/v1alpha/version', self._version)
        r.add_get('/api/v1alpha/supported_regions', self._supported_regions)
        r.add_get('/api/v1alpha/default_region', self._default_region)
        r.add_get('/api/v1alpha/cloud', self._cloud)
        # batches
        r.add_post('/api/v1alpha/batches/create', self._create_batch)
        r.add_post('/api/v1alpha/batches/create-fast', self._create_fast)
        r.add_post('/api/v1alpha/batches/{batch_id}/update-fast',
                   self._update_fast)
        r.add_get('/api/v1alpha/batches', self._list_batches)
        r.add_get('/api/v2alpha/batches', self._list_batches_v2)
        r.add_get('/api/v1alpha/batches/{batch_id}', self._get_batch)
        r.add_patch('/api/v1alpha/batches/{batch_id}/cancel', self._cancel_batch)
        r.add_delete('/api/v1alpha/batches/{batch_id}', self._delete_batch)
        r.add_patch('/api/v1alpha/batches/{batch_id}/close', self._close_batch)
        # updates
        r.add_post('/api/v1alpha/batches/{batch_id}/updates/create',
                   self._create_update)
        r.add_post('/api/v1alpha/batches/{batch_id}/updates/{update_id}/jobs/create',
                   self._create_jobs_in_update)
        r.add_post('/api/v1alpha/batches/{batch_id}/updates/{update_id}/job-groups/create',
                   self._create_job_groups_in_update)
        r.add_patch('/api/v1alpha/batches/{batch_id}/updates/{update_id}/commit',
                    self._commit_update)
        # legacy direct creation (internal client + reference back-compat)
        r.add_post('/api/v1alpha/batches/{batch_id}/jobs/create',
                   self._create_jobs_legacy)
        r.add_post('/api/v1alpha/batches/{batch_id}/job-groups/create',
                   self._create_job_groups_legacy)
        # jobs
        r.add_get('/api/v1alpha/batches/{batch_id}/jobs', self._list_jobs)
        r.add_get('/api/v2alpha/batches/{batch_id}/jobs', self._list_jobs)
        r.add_get('/api/v1alpha/batches/{batch_id}/jobs/{job_id}', self._get_job)
        r.add_get('/api/v1alpha/batches/{batch_id}/jobs/{job_id}/log', self._get_log)
        r.add_get('/api/v1alpha/batches/{batch_id}/jobs/{job_id}/log/{container}',
                  self._get_container_log)
        r.add_get('/api/v1alpha/batches/{batch_id}/jobs/{job_id}/attempts',
                  self._get_attempts)
        r.add_get('/api/v1alpha/batches/{batch_id}/jobs/{job_id}/resource_usage',
                  self._job_resource_usage)
        # job groups
        r.add_get('/api/v1alpha/batches/{batch_id}/job-groups/{group_id}',
                  self._get_job_group)
        r.add_get('/api/v1alpha/batches/{batch_id}/job-groups/{group_id}/job-groups',
                  self._list_child_job_groups)
        r.add_get('/api/v1alpha/batches/{batch_id}/job-groups/{group_id}/jobs',
                  self._list_job_group_jobs)
        r.add_get('/api/v2alpha/batches/{batch_id}/job-groups/{group_id}/jobs',
                  self._list_job_group_jobs)
        r.add_patch('/api/v1alpha/batches/{batch_id}/job-groups/{group_id}/cancel',
                    self._cancel_job_group)
        # billing
        r.add_get('/api/v1alpha/billing_projects', self._list_billing_projects)
        r.add_get('/api/v1alpha/billing_projects/{name}', self._get_billing_project)
        r.add_post('/api/v1alpha/billing_projects/{name}/create',
                   self._create_billing_project)
        r.add_post('/api/v1alpha/billing_projects/{name}/close',
                   self._close_billing_project)
        r.add_post('/api/v1alpha/billing_projects/{name}/reopen',
                   self._reopen_billing_project)
        r.add_post('/api/v1alpha/billing_projects/{name}/delete',
                   self._delete_billing_project)
        r.add_post('/api/v1alpha/billing_projects/{name}/users/{user}/add',
                   self._billing_add_user)
        r.add_post('/api/v1alpha/billing_projects/{name}/users/{user}/remove',
                   self._billing_remove_user)
        r.add_post('/api/v1alpha/billing_limits/{name}/edit',
                   self._edit_billing_limit)
        r.add_post('/api/v1alpha/billing_projects/{name}/edit',
                   self._edit_billing_limit)
        return app

    # endpoints reachable without credentials
    _OPEN_PATHS = {'/healthcheck', '/metrics', '/api/v1alpha/version',
                   '/api/v1alpha/supported_regions',
                   '/api/v1alpha/default_region', '/api/v1alpha/cloud'}

    def _auth_middleware(self):
        """Reference gear.auth: API routes require a Bearer token (401);
        UI GETs redirect to login (302), UI POSTs 401. With an auth service
        configured the token resolves to userdata; standalone, any
        non-empty token is accepted as the default dev user."""
        import aiohttp as _aiohttp
        from ..services.gear import get_session_id

        @web.middleware
        async def middleware(request, handler):
            if request.path in self._OPEN_PATHS:
                return await handler(request)
            session_id = await get_session_id(request)
            if not session_id:
                if not request.path.startswith('/api/'):
                    if request.method == 'GET':
                        raise web.HTTPFound('/login')
                    raise web.HTTPUnauthorized(reason='not authenticated')
                raise web.HTTPUnauthorized(reason='not authenticated')
            if self.auth_url:
                async with _aiohttp.ClientSession() as s:
                    async with s.get(
                            f'{self.auth_url}/api/v1alpha/userinfo',
                            headers={'Authorization':
                                     f'Bearer {session_id}'}) as resp:
                        if resp.status != 200:
                            raise web.HTTPUnauthorized(reason='invalid token')
                        request['userdata'] = await resp.json()
            return await handler(request)
        return middleware

    def _user_of(self, req: web.Request) -> str:
        ud = req.get('userdata') if hasattr(req, 'get') else None
        if isinstance(ud, dict) and ud.get('username'):
            return ud['username']
        return self.default_user

    # -- misc ---------------------------------------------------------------
    async def _healthcheck(self, req):
        return web.Response()

    async def _check_invariants(self, req):
        """DB-invariant sweep (reference batch-driver `/check_invariants`,
        validated by `batch/test/test_invariants.py`): recompute ground
        truth from the jobs/attempts tables and compare against the cached
        batch-level counters and the billing aggregation."""
        db = self.db
        inc_err = None
        agg_err = None
        try:
            for b in db.query('SELECT * FROM batches'):
                bid = b['id']
                jobs = db.query(
                    'SELECT * FROM jobs WHERE batch_id = ? AND committed = 1',
                    (bid,))
                if b['state'] != 'open' and b['n_jobs'] != len(jobs):
                    inc_err = (f'batch {bid}: n_jobs={b["n_jobs"]} but '
                               f'{len(jobs)} committed jobs')
                    break
                terminal = ('Success', 'Failed', 'Cancelled', 'Error')
                n_done = sum(1 for j in jobs if j['state'] in terminal)
                if b['state'] == 'complete' and n_done != len(jobs):
                    inc_err = (f'batch {bid}: complete with {n_done}/'
                               f'{len(jobs)} terminal jobs')
                    break
                for j in jobs:
                    if j['state'] == 'Success' and j['exit_code'] not in (0,):
                        inc_err = (f'job {bid}/{j["job_id"]}: Success with '
                                   f'exit_code {j["exit_code"]}')
                        break
                    if j['state'] in ('Success', 'Failed') \
                            and j['time_completed'] is None:
                        inc_err = (f'job {bid}/{j["job_id"]}: terminal '
                                   f'without time_completed')
                        break
                    n_att = db.query(
                        'SELECT COUNT(*) c FROM attempts WHERE batch_id = ? '
                        'AND job_id = ?', (bid, j['job_id']))[0]['c']
                    if n_att > j['attempts']:
                        inc_err = (f'job {bid}/{j["job_id"]}: {n_att} '
                                   f'attempt rows > attempts={j["attempts"]}')
                        break
                if inc_err:
                    break
            # resource aggregation: the batch-level cost/duration aggregate
            # must equal the recomputed per-job sum
            if inc_err is None:
                for b in db.query('SELECT id FROM batches'):
                    bid = b['id']
                    st = batch_status_dict(db, bid)
                    job_rows = db.query(
                        'SELECT duration_ms FROM jobs WHERE '
                        'batch_id = ? AND committed = 1', (bid,))
                    per_job = sum(_cost_of_ms(j['duration_ms'] or 0)
                                  for j in job_rows)
                    # _cost_of_ms rounds to 10 places: the batch-level
                    # aggregate (rounded once) may differ from the per-job
                    # sum (rounded n times) by up to n half-ulps
                    tol = 0.5e-10 * (len(job_rows) + 1) + 1e-12
                    if abs(st['cost'] - per_job) > tol:
                        agg_err = (f'batch {bid}: cost {st["cost"]} != '
                                   f'sum of job costs {per_job}')
                        break
        except Exception as e:   # noqa: BLE001 — surface as the error field
            inc_err = inc_err or repr(e)
        return web.json_response({'check_incremental_error': inc_err,
                                  'check_resource_aggregation_error': agg_err})

    async def _version(self, req):
        return web.Response(text='hail_tpu-batch')

    async def _supported_regions(self, req):
        import os
        regions = os.environ.get('HAIL_BATCH_REGIONS', 'local').split(',')
        return web.json_response(regions)

    async def _default_region(self, req):
        import os
        return web.Response(
            text=os.environ.get('HAIL_BATCH_REGIONS', 'local').split(',')[0])

    async def _cloud(self, req):
        import os
        return web.Response(text=os.environ.get('HAIL_CLOUD', 'local'))

    async def _metrics(self, req):
        from ..services.metrics import render_metrics
        extra = {'batch_running_jobs': float(len(self.driver.running)),
                 'batch_worker_slots': float(self.driver.autoscaler.n_slots)}
        for r in self.db.query(
                'SELECT state, COUNT(*) c FROM jobs GROUP BY state'):
            extra[f'batch_jobs_{r["state"].lower()}'] = float(r['c'])
        return web.Response(text=render_metrics(extra),
                            content_type='text/plain', charset='utf-8')

    # -- batch lifecycle ----------------------------------------------------
    def _batch_row(self, bid: int):
        rows = self.db.query('SELECT * FROM batches WHERE id = ?', (bid,))
        if not rows:
            raise web.HTTPNotFound(reason=f'batch {bid} not found')
        return rows[0]

    async def _create_batch(self, req: web.Request):
        spec = await req.json()
        user = self._user_of(req)
        return web.json_response(self._create_batch_impl(spec, user))

    def _create_batch_impl(self, spec, user: str) -> dict:
        try:
            validate_batch(spec)
        except ValidationError as e:
            raise web.HTTPBadRequest(reason=str(e))
        token = spec['token']
        existing = self.db.query(
            'SELECT id FROM batches WHERE token = ? AND user = ?',
            (token, user))
        if existing:
            bid = existing[0]['id']
            upd = self.db.query(
                'SELECT update_id, start_job_id FROM updates WHERE '
                'batch_id = ? AND update_id = 1', (bid,))
            return {
                'id': bid, 'update_id': 1 if upd else None,
                'start_job_id': upd[0]['start_job_id'] if upd else 1,
                'start_job_group_id': 1}
        bp = spec.get('billing_project', 'local')
        bpj = self._billing_project_json(bp)
        if bpj['status'] == 'closed':
            raise web.HTTPForbidden(
                reason=f'billing project {bp} is closed')
        if bpj['limit'] is not None and bpj['accrued_cost'] >= bpj['limit']:
            raise web.HTTPForbidden(
                reason=f'billing project {bp} has exceeded the budget: '
                       f'accrued={bpj["accrued_cost"]} limit={bpj["limit"]}')
        now = _now_ms()
        cur = self.db.execute(
            'INSERT INTO batches (user, billing_project, token, attributes, '
            'callback, cancel_after_n_failures, n_jobs, state, cancelled, '
            'time_created) VALUES (?, ?, ?, ?, ?, ?, 0, ?, 0, ?)',
            (user, bp, token, json.dumps(spec.get('attributes') or {}),
             spec.get('callback'), spec.get('cancel_after_n_failures'),
             'open', now))
        bid = cur.lastrowid
        self.db.execute(
            'INSERT INTO job_groups (batch_id, job_group_id, update_id, '
            'parent_id, attributes, cancelled, state, time_created) '
            'VALUES (?, 0, 0, NULL, ?, 0, ?, ?)',
            (bid, json.dumps({}), 'running', now))
        n_jobs = spec['n_jobs']
        update_id = None
        start_job_id = 1
        if n_jobs > 0 or spec.get('n_job_groups', 0) > 0:
            update_id = 1
            self.db.execute(
                'INSERT INTO updates (batch_id, update_id, token, '
                'start_job_id, n_jobs, start_job_group_id, n_job_groups, '
                'committed) VALUES (?, 1, ?, 1, ?, 1, ?, 0)',
                (bid, token, n_jobs, spec.get('n_job_groups', 0)))
        return {'id': bid, 'update_id': update_id,
                'start_job_id': start_job_id,
                'start_job_group_id': 1}

    async def _create_update(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        spec = await req.json()
        return web.json_response(self._create_update_impl(bid, spec))

    def _create_update_impl(self, bid: int, spec) -> dict:
        b = self._batch_row(bid)
        if b['state'] == 'cancelled' or b['cancelled']:
            raise web.HTTPBadRequest(
                reason='Cannot submit new jobs or job groups to a '
                       f'cancelled batch {bid}')
        try:
            validate_update(spec)
        except ValidationError as e:
            raise web.HTTPBadRequest(reason=str(e))
        existing = self.db.query(
            'SELECT * FROM updates WHERE batch_id = ? AND token = ?',
            (bid, spec['token']))
        if existing:
            u = existing[0]
            return {
                'update_id': u['update_id'],
                'start_job_id': u['start_job_id'],
                'start_job_group_id': u['start_job_group_id']}
        last = self.db.query(
            'SELECT COALESCE(MAX(update_id), 0) u, '
            'COALESCE(SUM(n_jobs), 0) nj, COALESCE(SUM(n_job_groups), 0) ng '
            'FROM updates WHERE batch_id = ?', (bid,))[0]
        update_id = last['u'] + 1
        start_job_id = last['nj'] + 1
        start_job_group_id = last['ng'] + 1
        self.db.execute(
            'INSERT INTO updates (batch_id, update_id, token, start_job_id, '
            'n_jobs, start_job_group_id, n_job_groups, committed) '
            'VALUES (?, ?, ?, ?, ?, ?, ?, 0)',
            (bid, update_id, spec['token'], start_job_id, spec['n_jobs'],
             start_job_group_id, spec.get('n_job_groups', 0)))
        return {'update_id': update_id,
                'start_job_id': start_job_id,
                'start_job_group_id': start_job_group_id}

    def _update_row(self, bid: int, uid: int):
        rows = self.db.query(
            'SELECT * FROM updates WHERE batch_id = ? AND update_id = ?',
            (bid, uid))
        if not rows:
            raise web.HTTPNotFound(reason=f'update {bid}/{uid} not found')
        return rows[0]

    def _group_depth(self, bid: int, gid: int) -> int:
        depth = 0
        cur: Optional[int] = gid
        while cur is not None and cur != 0:
            rows = self.db.query(
                'SELECT parent_id FROM job_groups WHERE batch_id = ? AND '
                'job_group_id = ?', (bid, cur))
            if not rows:
                break
            cur = rows[0]['parent_id']
            depth += 1
        return depth

    def _group_cancelled(self, bid: int, gid: int) -> bool:
        """True when the batch, the group, or any ancestor group is
        cancelled (reference job_group_self_and_ancestors join)."""
        b = self.db.query('SELECT cancelled FROM batches WHERE id = ?',
                          (bid,))
        if b and b[0]['cancelled']:
            return True
        cur: Optional[int] = gid
        while cur is not None:
            rows = self.db.query(
                'SELECT parent_id, cancelled FROM job_groups WHERE '
                'batch_id = ? AND job_group_id = ?', (bid, cur))
            if not rows:
                return False
            if rows[0]['cancelled']:
                return True
            cur = rows[0]['parent_id']
        return False

    def _insert_job_groups(self, bid: int, upd, bunch) -> List[int]:
        created = []
        start = upd['start_job_group_id'] if upd is not None else None
        for gspec in bunch:
            try:
                validate_job_group(gspec)
            except ValidationError as e:
                raise web.HTTPBadRequest(reason=str(e))
            rel = int(gspec['job_group_id'])
            gid = (start + rel - 1) if start is not None else rel
            if 'absolute_parent_id' in gspec:
                parent = int(gspec['absolute_parent_id'])
            elif 'in_update_parent_id' in gspec and start is not None:
                parent = start + int(gspec['in_update_parent_id']) - 1
            else:
                parent = 0
            prows = self.db.query(
                'SELECT job_group_id FROM job_groups WHERE batch_id = ? AND '
                'job_group_id = ?', (bid, parent))
            if not prows:
                raise web.HTTPBadRequest(
                    reason=f'parent job group {parent} does not exist')
            if self._group_depth(bid, parent) + 1 > MAX_JOB_GROUPS_DEPTH:
                raise web.HTTPBadRequest(
                    reason='job group exceeded the maximum level of '
                           f'nesting (MAX_JOB_GROUPS_DEPTH='
                           f'{MAX_JOB_GROUPS_DEPTH})')
            self.db.execute(
                'INSERT INTO job_groups (batch_id, job_group_id, update_id, '
                'parent_id, attributes, callback, cancel_after_n_failures, '
                'cancelled, state, time_created) '
                'VALUES (?, ?, ?, ?, ?, ?, ?, 0, ?, ?)',
                (bid, gid, upd['update_id'] if upd is not None else 0, parent,
                 json.dumps(gspec.get('attributes') or {}),
                 gspec.get('callback'), gspec.get('cancel_after_n_failures'),
                 'running', _now_ms()))
            created.append(gid)
        return created

    def _insert_jobs(self, bid: int, upd, bunch, committed: int) -> List[int]:
        created = []
        start = upd['start_job_id'] if upd is not None else None
        gstart = upd['start_job_group_id'] if upd is not None else None
        for jspec in bunch:
            try:
                validate_job(jspec)
            except ValidationError as e:
                raise web.HTTPBadRequest(reason=str(e))
            rel = int(jspec['job_id'])
            jid = (start + rel - 1) if start is not None else rel
            parents = [int(p) for p in jspec.get('absolute_parent_ids', [])]
            parents += [int(p) for p in jspec.get('parent_ids', [])]
            if start is not None:
                parents += [start + int(p) - 1
                            for p in jspec.get('in_update_parent_ids', [])]
            for p in parents:
                if not (0 < p < jid):
                    raise web.HTTPBadRequest(
                        reason=f'job {jid}: parents with invalid job ids: {p}')
            if 'absolute_job_group_id' in jspec:
                gid = int(jspec['absolute_job_group_id'])
            elif 'in_update_job_group_id' in jspec and gstart is not None:
                gid = gstart + int(jspec['in_update_job_group_id']) - 1
            else:
                gid = int(jspec.get('job_group_id', 0))
            grows = self.db.query(
                'SELECT job_group_id FROM job_groups WHERE batch_id = ? AND '
                'job_group_id = ?', (bid, gid))
            if not grows:
                raise web.HTTPBadRequest(
                    reason=f'job group {gid} does not exist')
            if self._group_cancelled(bid, gid):
                raise web.HTTPBadRequest(
                    reason='bunch contains job where the job group has '
                           'already been cancelled')
            spec = dict(jspec)
            inner = spec.pop('spec', None)
            if isinstance(inner, dict):
                # legacy internal-client shape: {'job_id', 'spec': {...}}
                for k, v in inner.items():
                    spec.setdefault(k, v)
            spec.pop('absolute_parent_ids', None)
            spec.pop('in_update_parent_ids', None)
            spec.pop('parent_ids', None)
            self.db.execute(
                'INSERT INTO jobs (batch_id, job_id, update_id, job_group_id, '
                'spec, state, attempts, n_max_attempts, always_run, parents, '
                'committed) VALUES (?, ?, ?, ?, ?, ?, 0, ?, ?, ?, ?)',
                (bid, jid, upd['update_id'] if upd is not None else 0, gid,
                 json.dumps(spec), 'Pending',
                 int(jspec.get('n_max_attempts', 20)),
                 1 if jspec.get('always_run') else 0,
                 json.dumps(parents), committed))
            created.append(jid)
        return created

    @staticmethod
    async def _read_bunch(req: web.Request):
        """Accept either {'bunch': [...]} JSON or newline-delimited JSON
        specs (the reference submits text/plain concatenated spec bytes)."""
        ctype = req.headers.get('Content-Type', '')
        raw = await req.read()
        if not raw:
            return []
        if 'json' in ctype:
            payload = json.loads(raw)
            if isinstance(payload, dict):
                return payload.get('bunch', payload)
            return payload
        text = raw.decode()
        text = text.strip()
        if text.startswith('['):
            return json.loads(text)
        return [json.loads(line) for line in text.splitlines() if line.strip()]

    async def _create_jobs_in_update(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        uid = int(req.match_info['update_id'])
        self._batch_row(bid)
        upd = self._update_row(bid, uid)
        if upd['committed']:
            raise web.HTTPBadRequest(reason=f'update {uid} is committed')
        bunch = await self._read_bunch(req)
        created = self._insert_jobs(bid, upd, bunch, committed=0)
        return web.json_response({'job_ids': created})

    async def _create_job_groups_in_update(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        uid = int(req.match_info['update_id'])
        self._batch_row(bid)
        upd = self._update_row(bid, uid)
        bunch = await self._read_bunch(req)
        created = self._insert_job_groups(bid, upd, bunch)
        return web.json_response({'job_group_ids': created})

    async def _commit_update(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        uid = int(req.match_info['update_id'])
        return web.json_response(self._commit_update_impl(bid, uid))

    def _commit_update_impl(self, bid: int, uid: int) -> dict:
        b = self._batch_row(bid)
        upd = self._update_row(bid, uid)
        if not upd['committed']:
            n_new = self.db.query(
                'SELECT COUNT(*) c FROM jobs WHERE batch_id = ? AND '
                'update_id = ?', (bid, uid))[0]['c']
            self.db.execute(
                'UPDATE updates SET committed = 1 WHERE batch_id = ? AND '
                'update_id = ?', (bid, uid))
            self.db.execute(
                'UPDATE jobs SET committed = 1 WHERE batch_id = ? AND '
                'update_id = ?', (bid, uid))
            self.db.execute(
                'UPDATE batches SET n_jobs = n_jobs + ? WHERE id = ?',
                (n_new, bid))
        if b['state'] == 'open':
            self.db.execute(
                "UPDATE batches SET state = 'running', time_closed = ? "
                "WHERE id = ? AND state = 'open'", (_now_ms(), bid))
        elif b['state'] == 'complete':
            # an update to a completed batch returns it to running until the
            # new jobs finish (reference update semantics, front_end.py
            # commit_update)
            self.db.execute(
                "UPDATE batches SET state = 'running', time_completed = NULL "
                "WHERE id = ? AND state = 'complete'", (bid,))
        self.driver.wake()
        start_job_id = upd['start_job_id']
        return {'start_job_id': start_job_id,
                'start_job_group_id': upd['start_job_group_id']}

    async def _create_fast(self, req: web.Request):
        """POST /api/v1alpha/batches/create-fast: batch + one bunch of job
        groups/jobs + commit in a single request (reference front_end
        create_batch_fast; the client takes this path when everything fits
        one bunch)."""
        body = await req.json()
        user = self._user_of(req)
        created = self._create_batch_impl(body.get('batch') or {}, user)
        bid = created['id']
        uid = created.get('update_id')
        if uid is not None:
            upd = self._update_row(bid, uid)
            self._insert_job_groups(bid, upd, body.get('job_groups') or [])
            self._insert_jobs(bid, upd, body.get('bunch') or [], committed=0)
            self._commit_update_impl(bid, uid)
        else:
            self.db.execute(
                "UPDATE batches SET state = 'running', time_closed = ? "
                "WHERE id = ? AND state = 'open'", (_now_ms(), bid))
        return web.json_response({'id': bid,
                                  'start_job_id': created['start_job_id'],
                                  'start_job_group_id':
                                      created['start_job_group_id']})

    async def _update_fast(self, req: web.Request):
        """POST /api/v1alpha/batches/{id}/update-fast: update + one bunch
        + commit in a single request (reference update_batch_fast)."""
        bid = int(req.match_info['batch_id'])
        body = await req.json()
        created = self._create_update_impl(bid, body.get('update') or {})
        uid = created['update_id']
        upd = self._update_row(bid, uid)
        self._insert_job_groups(bid, upd, body.get('job_groups') or [])
        self._insert_jobs(bid, upd, body.get('bunch') or [], committed=0)
        self._commit_update_impl(bid, uid)
        return web.json_response({'update_id': uid,
                                  'start_job_id': created['start_job_id'],
                                  'start_job_group_id':
                                      created['start_job_group_id']})

    async def _create_jobs_legacy(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        b = self._batch_row(bid)
        if b['state'] not in ('open', 'running'):
            raise web.HTTPBadRequest(reason=f'batch {bid} is not open')
        bunch = await self._read_bunch(req)
        committed = 1 if b['state'] != 'open' else 1
        created = self._insert_jobs(bid, None, bunch, committed=committed)
        self.db.execute(
            'UPDATE batches SET n_jobs = n_jobs + ? WHERE id = ?',
            (len(created), bid))
        self.driver.wake()
        return web.json_response({'job_ids': created})

    async def _create_job_groups_legacy(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        b = self._batch_row(bid)
        if b['state'] not in ('open', 'running'):
            raise web.HTTPBadRequest(reason=f'batch {bid} is {b["state"]}')
        bunch = await self._read_bunch(req)
        created = self._insert_job_groups(bid, None, bunch)
        return web.json_response({'job_group_ids': created})

    async def _close_batch(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        self._batch_row(bid)
        self.db.execute(
            "UPDATE batches SET state = 'running', time_closed = ? "
            "WHERE id = ? AND state = 'open'", (_now_ms(), bid))
        # commit any open updates (legacy close semantics)
        for u in self.db.query(
                'SELECT update_id FROM updates WHERE batch_id = ? AND '
                'committed = 0', (bid,)):
            n_new = self.db.query(
                'SELECT COUNT(*) c FROM jobs WHERE batch_id = ? AND '
                'update_id = ?', (bid, u['update_id']))[0]['c']
            self.db.execute(
                'UPDATE updates SET committed = 1 WHERE batch_id = ? AND '
                'update_id = ?', (bid, u['update_id']))
            self.db.execute(
                'UPDATE jobs SET committed = 1 WHERE batch_id = ? AND '
                'update_id = ?', (bid, u['update_id']))
            self.db.execute(
                'UPDATE batches SET n_jobs = n_jobs + ? WHERE id = ?',
                (n_new, bid))
        self.driver.wake()
        return web.json_response({})

    async def _get_batch(self, req: web.Request):
        return web.json_response(
            batch_status_dict(self.db, int(req.match_info['batch_id'])))

    async def _cancel_batch(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        b = self._batch_row(bid)
        if b['state'] == 'open':
            raise web.HTTPBadRequest(reason=f'cannot cancel open batch {bid}')
        self.driver.cancel_batch(bid)
        return web.json_response({})

    async def _delete_batch(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        self._batch_row(bid)
        self.driver.cancel_batch(bid)
        self.db.execute('DELETE FROM jobs WHERE batch_id = ?', (bid,))
        self.db.execute('DELETE FROM job_groups WHERE batch_id = ?', (bid,))
        self.db.execute('DELETE FROM updates WHERE batch_id = ?', (bid,))
        self.db.execute('DELETE FROM attempts WHERE batch_id = ?', (bid,))
        self.db.execute('DELETE FROM batches WHERE id = ?', (bid,))
        return web.json_response({})

    async def _list_batches(self, req: web.Request, version: int = 1):
        q = req.query.get('q')
        last = req.query.get('last_batch_id')
        user = self._user_of(req)
        sql = 'SELECT id FROM batches WHERE user = ?'
        args: List[Any] = [user]
        if last is not None:
            sql += ' AND id < ?'
            args.append(int(last))
        sql += ' ORDER BY id DESC'
        out = []
        last_id = None
        for r in self.db.query(sql, tuple(args)):
            st = batch_status_dict(self.db, r['id'])
            if batch_matches_query(st, q, version):
                out.append(st)
                if len(out) >= self.PAGE_SIZE:
                    last_id = r['id']
                    break
        resp = {'batches': out}
        if last_id is not None:
            resp['last_batch_id'] = last_id
        return web.json_response(resp)

    async def _list_batches_v2(self, req: web.Request):
        return await self._list_batches(req, version=2)

    # -- jobs ---------------------------------------------------------------
    def _job_row(self, bid: int, jid: int):
        rows = self.db.query(
            'SELECT * FROM jobs WHERE batch_id = ? AND job_id = ? AND '
            'committed = 1', (bid, jid))
        if not rows:
            raise web.HTTPNotFound(reason=f'job {bid}/{jid} not found')
        return rows[0]

    def _list_jobs_common(self, req: web.Request, gids: Optional[List[int]]):
        bid = int(req.match_info['batch_id'])
        b = self._batch_row(bid)
        q = req.query.get('q')
        version = 2 if '/v2alpha/' in req.path else 1
        last = req.query.get('last_job_id')
        sql = ('SELECT * FROM jobs WHERE batch_id = ? AND committed = 1')
        args: List[Any] = [bid]
        if gids is not None:
            qmarks = ','.join('?' * len(gids))
            sql += f' AND job_group_id IN ({qmarks})'
            args.extend(gids)
        if last is not None:
            sql += ' AND job_id > ?'
            args.append(int(last))
        sql += ' ORDER BY job_id'
        out = []
        last_id = None
        for r in self.db.query(sql, tuple(args)):
            spec = json.loads(r['spec'])
            entry = job_list_entry(self.db, r, b['user'],
                                   b['billing_project'])
            entry['_time_started_ms'] = r['time_started']
            matched = job_matches_query(entry, spec, q, version)
            entry.pop('_time_started_ms', None)
            if matched:
                out.append(entry)
                if len(out) >= self.PAGE_SIZE:
                    last_id = r['job_id']
                    break
        resp = {'jobs': out}
        if last_id is not None:
            resp['last_job_id'] = last_id
        return web.json_response(resp)

    async def _list_jobs(self, req: web.Request):
        return self._list_jobs_common(req, None)

    async def _get_job(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        jid = int(req.match_info['job_id'])
        b = self._batch_row(bid)
        r = self._job_row(bid, jid)
        return web.json_response(
            full_job_dict(self.db, r, b['user'], b['billing_project']))

    async def _get_log(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        jid = int(req.match_info['job_id'])
        r = self._job_row(bid, jid)
        logs = json.loads(r['logs']) if r['logs'] else {}
        return web.json_response({'main': logs.get('main', ''),
                                  **{k: v for k, v in logs.items()
                                     if k != 'main'}})

    async def _get_container_log(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        jid = int(req.match_info['job_id'])
        container = req.match_info['container']
        r = self._job_row(bid, jid)
        logs = json.loads(r['logs']) if r['logs'] else {}
        if container not in ('input', 'main', 'output'):
            raise web.HTTPBadRequest(reason=f'unknown container {container}')
        return web.Response(body=(logs.get(container) or '').encode())

    async def _get_attempts(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        jid = int(req.match_info['job_id'])
        self._job_row(bid, jid)
        rows = self.db.query(
            'SELECT * FROM attempts WHERE batch_id = ? AND job_id = ? '
            'ORDER BY start_time', (bid, jid))
        if not rows:
            return web.json_response(None)
        return web.json_response([
            {'batch_id': bid, 'job_id': jid, 'attempt_id': r['attempt_id'],
             'start_time': _time_str(r['start_time']),
             'end_time': _time_str(r['end_time']),
             'duration': ((r['end_time'] - r['start_time'])
                          if r['end_time'] is not None
                          and r['start_time'] is not None else None),
             'reason': r['reason']}
            for r in rows])

    async def _job_resource_usage(self, req: web.Request):
        # reference shape: {task: {columns: [...], data: [...]}} — one key
        # per container, each convertible to a dataframe (aioclient
        # Job.resource_usage docstring)
        bid = int(req.match_info['batch_id'])
        jid = int(req.match_info['job_id'])
        r = self._job_row(bid, jid)
        dur = r['duration_ms'] or 0
        cols = ['time_msecs', 'memory_in_bytes', 'cpu_usage',
                'non_io_storage_in_bytes', 'io_storage_in_bytes',
                'network_bandwidth_upload_in_bytes_per_second',
                'network_bandwidth_download_in_bytes_per_second']
        t0 = r['time_started'] or 0
        out = {}
        for task in ('input', 'main', 'output'):
            out[task] = {'columns': cols,
                         'data': [[t0, 0, min(dur / 1000.0, 1.0), 0, 0,
                                   0, 0]]}
        # legacy summary shape used by the internal client
        out['resource_usage'] = {'cpu_seconds': dur / 1000.0, 'cores': 1,
                                 'cost': _cost_of_ms(dur)}
        return web.json_response(out)

    # -- job groups ---------------------------------------------------------
    async def _get_job_group(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        gid = int(req.match_info['group_id'])
        self._batch_row(bid)
        return web.json_response(job_group_status_dict(self.db, bid, gid))

    async def _list_child_job_groups(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        gid = int(req.match_info['group_id'])
        self._batch_row(bid)
        job_group_status_dict(self.db, bid, gid)    # 404 if absent
        last = req.query.get('last_job_group_id')
        # only groups from COMMITTED updates are visible (reference
        # parse_list_job_groups_query_v1: batch_updates.committed filter)
        sql = ('SELECT g.job_group_id AS job_group_id FROM job_groups g '
               'LEFT JOIN updates u ON u.batch_id = g.batch_id AND '
               'u.update_id = g.update_id '
               'WHERE g.batch_id = ? AND g.parent_id = ? AND '
               '(u.committed = 1 OR u.update_id IS NULL OR g.update_id = 0)')
        args: List[Any] = [bid, gid]
        if last is not None:
            sql += ' AND job_group_id > ?'
            args.append(int(last))
        sql += ' ORDER BY job_group_id'
        out = []
        last_id = None
        for r in self.db.query(sql, tuple(args)):
            out.append(job_group_status_dict(self.db, bid, r['job_group_id']))
            if len(out) >= self.PAGE_SIZE:
                last_id = r['job_group_id']
                break
        resp = {'job_groups': out}
        if last_id is not None:
            resp['last_job_group_id'] = last_id
        return web.json_response(resp)

    async def _list_job_group_jobs(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        gid = int(req.match_info['group_id'])
        self._batch_row(bid)
        job_group_status_dict(self.db, bid, gid)
        # default recursive when the param is absent (internal clients);
        # the reference aioclient always sends it explicitly
        recursive = req.query.get('recursive', 'True').lower() in (
            'true', '1')
        if recursive or gid == 0:
            gids = _descendant_groups(self.db, bid, gid)
        else:
            gids = [gid]
        return self._list_jobs_common(req, gids)

    async def _cancel_job_group(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        gid = int(req.match_info['group_id'])
        self._batch_row(bid)
        job_group_status_dict(self.db, bid, gid)
        self.driver.cancel_job_group(bid, gid)
        return web.json_response({})

    # -- billing ------------------------------------------------------------
    def _billing_project_json(self, name: str) -> dict:
        rows = self.db.query('SELECT * FROM billing_projects WHERE name = ?',
                             (name,))
        limit = rows[0]['limit_cost'] if rows else None
        status = rows[0]['status'] if rows else 'open'
        users = json.loads(rows[0]['users']) if rows else []
        cost = 0.0
        for b in self.db.query('SELECT id FROM batches WHERE '
                               'billing_project = ?', (name,)):
            dur = self.db.query(
                'SELECT SUM(duration_ms) s FROM jobs WHERE batch_id = ?',
                (b['id'],))
            cost += _cost_of_ms(int(dur[0]['s'] or 0))
        return {'billing_project': name, 'limit': limit,
                'accrued_cost': round(cost, 10), 'status': status,
                'users': users}

    async def _list_billing_projects(self, req: web.Request):
        names = {r['name'] for r in
                 self.db.query('SELECT name FROM billing_projects')}
        names |= {r['billing_project'] for r in self.db.query(
            'SELECT DISTINCT billing_project FROM batches')}
        return web.json_response(
            [self._billing_project_json(n) for n in sorted(names)])

    async def _get_billing_project(self, req: web.Request):
        return web.json_response(
            self._billing_project_json(req.match_info['name']))

    async def _create_billing_project(self, req: web.Request):
        name = req.match_info['name']
        if self.db.query('SELECT 1 FROM billing_projects WHERE name = ?',
                         (name,)):
            raise web.HTTPForbidden(
                reason=f'billing project {name} already exists')
        self.db.execute(
            "INSERT INTO billing_projects (name, status, users) "
            "VALUES (?, 'open', '[]')", (name,))
        return web.json_response(self._billing_project_json(name))

    def _set_bp_status(self, name: str, status: str):
        if not self.db.query('SELECT 1 FROM billing_projects WHERE name = ?',
                             (name,)):
            raise web.HTTPNotFound(
                reason=f'billing project {name} not found')
        self.db.execute('UPDATE billing_projects SET status = ? '
                        'WHERE name = ?', (status, name))

    async def _close_billing_project(self, req: web.Request):
        self._set_bp_status(req.match_info['name'], 'closed')
        return web.json_response(
            self._billing_project_json(req.match_info['name']))

    async def _reopen_billing_project(self, req: web.Request):
        self._set_bp_status(req.match_info['name'], 'open')
        return web.json_response(
            self._billing_project_json(req.match_info['name']))

    async def _delete_billing_project(self, req: web.Request):
        self._set_bp_status(req.match_info['name'], 'deleted')
        return web.json_response(
            self._billing_project_json(req.match_info['name']))

    async def _billing_add_user(self, req: web.Request):
        name = req.match_info['name']
        user = req.match_info['user']
        rows = self.db.query('SELECT users FROM billing_projects '
                             'WHERE name = ?', (name,))
        if not rows:
            raise web.HTTPNotFound(reason=f'billing project {name} not found')
        users = json.loads(rows[0]['users'])
        if user not in users:
            users.append(user)
        self.db.execute('UPDATE billing_projects SET users = ? '
                        'WHERE name = ?', (json.dumps(users), name))
        return web.json_response(self._billing_project_json(name))

    async def _billing_remove_user(self, req: web.Request):
        name = req.match_info['name']
        user = req.match_info['user']
        rows = self.db.query('SELECT users FROM billing_projects '
                             'WHERE name = ?', (name,))
        if not rows:
            raise web.HTTPNotFound(reason=f'billing project {name} not found')
        users = [u for u in json.loads(rows[0]['users']) if u != user]
        self.db.execute('UPDATE billing_projects SET users = ? '
                        'WHERE name = ?', (json.dumps(users), name))
        return web.json_response(self._billing_project_json(name))

    async def _edit_billing_limit(self, req: web.Request):
        name = req.match_info['name']
        body = await req.json()
        limit = body.get('limit')
        if limit is not None and not isinstance(limit, (int, float)):
            raise web.HTTPBadRequest(reason='limit must be numeric or null')
        self.db.execute(
            "INSERT INTO billing_projects (name, limit_cost, status, users) "
            "VALUES (?, ?, 'open', '[]') ON CONFLICT(name) DO UPDATE SET "
            "limit_cost = excluded.limit_cost", (name, limit))
        return web.json_response(self._billing_project_json(name))

    # -- UI -----------------------------------------------------------------
    async def _ui_login(self, req: web.Request):
        from ..services.web_common import render_page
        return web.Response(
            text=render_page('Login', '<p>Authenticate with a session '
                             'token (hailctl auth login).</p>'),
            content_type='text/html')

    async def _ui_job(self, req: web.Request):
        from html import escape
        from ..services.web_common import render_page
        bid = int(req.match_info['batch_id'])
        jid = int(req.match_info['job_id'])
        r = self._job_row(bid, jid)
        logs = json.loads(r['logs']) if r['logs'] else {}
        body = (f'<p>state: {escape(r["state"])} exit: {r["exit_code"]}</p>'
                + ''.join(f'<h3>{escape(k)}</h3><pre>{escape(v)}</pre>'
                          for k, v in logs.items()))
        return web.Response(text=render_page(f'Job {bid}/{jid}', body),
                            content_type='text/html')

    async def _ui_cancel_batch(self, req: web.Request):
        bid = int(req.match_info['batch_id'])
        self._batch_row(bid)
        self.driver.cancel_batch(bid)
        raise web.HTTPFound('/batches')

    async def _ui_batches(self, req: web.Request):
        from ..services.web_common import render_page, render_table
        rows = []
        for r in self.db.query('SELECT id FROM batches ORDER BY id DESC'):
            s = batch_status_dict(self.db, r['id'])
            rows.append([f'<a href="/batches/{s["id"]}">{s["id"]}</a>',
                         s['state'], s['n_jobs'], s['n_completed'],
                         s['n_failed'], s['billing_project']])
        html = render_table(
            ['id', 'state', 'jobs', 'completed', 'failed', 'billing project'],
            rows, raw_cols=(0,))
        return web.Response(text=render_page('Batches', html),
                            content_type='text/html')

    async def _ui_batch(self, req: web.Request):
        from html import escape
        from ..services.web_common import render_page, render_table
        bid = int(req.match_info['batch_id'])
        s = batch_status_dict(self.db, bid)
        rows = []
        for r in self.db.query(
                'SELECT * FROM jobs WHERE batch_id = ? ORDER BY job_id',
                (bid,)):
            spec = json.loads(r['spec'])
            cmd = (spec.get('process') or {}).get('command') \
                or spec.get('command')
            cmd = ' '.join(cmd) if isinstance(cmd, list) else (cmd or '')
            rows.append([r['job_id'],
                         f'<span class="state-{escape(r["state"])}">'
                         f'{escape(r["state"])}</span>',
                         r['exit_code'], r['attempts'], cmd[:120]])
        html = (f'<p>state: {escape(s["state"])} — {s["n_completed"]}/'
                f'{s["n_jobs"]} jobs complete</p>'
                + render_table(['job', 'state', 'exit code', 'attempts',
                                'command'], rows, raw_cols=(1,)))
        return web.Response(text=render_page(f'Batch {bid}', html),
                            content_type='text/html')
