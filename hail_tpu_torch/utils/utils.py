"""General-purpose helpers (reference hailtop/utils/utils.py subset): chunk
partitioning, URL manipulation, docker image reference parsing, small list
combinators."""

from __future__ import annotations

import re
from typing import Any, Iterable, List, Optional, Tuple
from urllib.parse import parse_qsl, urljoin, urlparse, urlsplit


def partition(k: int, ls):
    """Split an indexable into k contiguous pieces; the first len(ls) % k
    pieces get one extra element. Slicing a range yields ranges."""
    if k == 0:
        assert len(ls) == 0
        return []
    assert k > 0
    base, rem = divmod(len(ls), k)
    out = []
    start = 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        out.append(ls[start:start + size])
        start += size
    return out


def grouped(n: int, ls):
    """Chunks of size n (last may be short)."""
    if n < 1:
        raise ValueError(f'invalid group size: {n}')
    out = []
    for i in range(0, len(ls), n):
        out.append(ls[i:i + n])
    return out


def digits_needed(i: int) -> int:
    assert i >= 0
    if i < 10:
        return 1
    return 1 + digits_needed(i // 10)


def filter_none(xs: Iterable) -> List:
    return [x for x in xs if x is not None]


def flatten(xss: Iterable[Iterable]) -> List:
    return [x for xs in xss for x in xs]


def unzip(pairs: Iterable[Tuple[Any, Any]]) -> Tuple[List, List]:
    a, b = [], []
    for x, y in pairs:
        a.append(x)
        b.append(y)
    return a, b


def url_basename(url: str) -> str:
    return url.rsplit('/', 1)[-1]


def url_join(url: str, path: str) -> str:
    return urljoin(url if url.endswith('/') else url + '/', path)


def url_scheme(url: str) -> str:
    return urlparse(url).scheme


def url_and_params(url: str) -> Tuple[str, dict]:
    parts = urlsplit(url)
    params = dict(parse_qsl(parts.query))
    base = parts._replace(query='').geturl()
    if url.endswith('?') or parts.query:
        base = base.rstrip('?')
    return base, params


class ParsedDockerImageReference:
    def __init__(self, domain: Optional[str], path: str, tag: Optional[str],
                 digest: Optional[str]):
        self.domain = domain
        self.path = path
        self.tag = tag
        self.digest = digest

    def name(self) -> str:
        if self.domain:
            return self.domain + '/' + self.path
        return self.path

    def __str__(self) -> str:
        out = self.name()
        if self.tag is not None:
            out += ':' + self.tag
        if self.digest is not None:
            out += '@' + self.digest
        return out


_DOCKER_REF_RE = re.compile(r'(?:([^/]+)/)?([^:@]+)(?::([^@]+))?(?:@(.+))?')


def parse_docker_image_reference(s: str) -> ParsedDockerImageReference:
    m = _DOCKER_REF_RE.fullmatch(s)
    if m is None:
        raise ValueError(f'could not parse {s!r} as a docker image reference')
    return ParsedDockerImageReference(m.group(1), m.group(2), m.group(3),
                                      m.group(4))
