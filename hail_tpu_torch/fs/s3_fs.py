"""S3-compatible filesystem driver (plain HTTP, no SDK).

The cloud-FS capability of the reference (`hailtop/aiocloud/aioaws/fs.py`
S3AsyncFS; Scala `is/hail/io/fs` drivers) implemented against any
S3-compatible endpoint — AWS, GCS-interop, minio, or the in-repo mock
(`fs/s3_mock.py`). The endpoint comes from `HAIL_TPU_S3_ENDPOINT` (e.g.
`http://127.0.0.1:9000`); requests are unsigned (the mock and
IAM-instance-profile setups accept this; SigV4 signing would slot into
`_req` without touching callers).

Paths: `s3://bucket/key`. Directory semantics are prefix semantics, as in
real object stores: `ls` of a "directory" lists one level using
delimiter=/; `mkdir` is a no-op; `is_dir` means "some key has this prefix".
"""

from __future__ import annotations

import io
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import IO, List, Optional, Tuple
from xml.etree import ElementTree

from .router_fs import FS, FileStatus


def _endpoint() -> str:
    ep = os.environ.get('HAIL_TPU_S3_ENDPOINT')
    if not ep:
        raise RuntimeError(
            's3:// support needs HAIL_TPU_S3_ENDPOINT (an S3-compatible '
            'endpoint URL; see hail_tpu/fs/s3_mock.py for the in-repo one)')
    return ep.rstrip('/')


def _split(path: str) -> Tuple[str, str]:
    assert path.startswith('s3://'), path
    rest = path[len('s3://'):]
    bucket, _, key = rest.partition('/')
    return bucket, key


class S3FS(FS):
    def __init__(self, endpoint: Optional[str] = None):
        self.endpoint = (endpoint or _endpoint()).rstrip('/')

    # -- low-level ----------------------------------------------------------
    def _req(self, method: str, bucket: str, key: str,
             data: Optional[bytes] = None, headers: Optional[dict] = None,
             query: str = ''):
        url = f'{self.endpoint}/{bucket}/{urllib.parse.quote(key)}'
        if query:
            url += '?' + query
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers or {})
        return urllib.request.urlopen(req, timeout=60)

    # -- FS surface ----------------------------------------------------------
    def open(self, path: str, mode: str = 'r',
             buffer_size: int = 8192) -> IO:
        bucket, key = _split(path)
        if 'r' in mode:
            try:
                with self._req('GET', bucket, key) as resp:
                    data = resp.read()
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    raise FileNotFoundError(path) from None
                raise
            return io.BytesIO(data) if 'b' in mode \
                else io.StringIO(data.decode())
        if 'w' in mode or 'x' in mode:
            fs = self

            class _Writer(io.BytesIO):
                def close(self2):
                    body = self2.getvalue()
                    fs._req('PUT', bucket, key, data=body).read()
                    io.BytesIO.close(self2)

                def __exit__(self2, *exc):
                    self2.close()

            w = _Writer()
            if 'b' in mode:
                return w
            return io.TextIOWrapper(w)
        raise ValueError(f'unsupported mode {mode!r}')

    def exists(self, path: str) -> bool:
        return self.is_file(path) or self.is_dir(path)

    def is_file(self, path: str) -> bool:
        bucket, key = _split(path)
        try:
            self._req('HEAD', bucket, key).read()
            return True
        except urllib.error.HTTPError:
            return False

    def is_dir(self, path: str) -> bool:
        bucket, key = _split(path)
        prefix = key.rstrip('/') + '/' if key else ''
        return bool(self._list(bucket, prefix, max_keys=1)[0]) or \
            bool(self._list(bucket, prefix, max_keys=1)[1])

    def stat(self, path: str) -> FileStatus:
        bucket, key = _split(path)
        try:
            with self._req('HEAD', bucket, key) as resp:
                size = int(resp.headers.get('Content-Length', 0))
            return FileStatus(path=path, size=size, is_dir=False,
                              modification_time=None)
        except urllib.error.HTTPError:
            if self.is_dir(path):
                return FileStatus(path=path, size=0, is_dir=True,
                                  modification_time=None)
            raise FileNotFoundError(path) from None

    def _list(self, bucket: str, prefix: str, max_keys: int = 1000):
        q = urllib.parse.urlencode({
            'list-type': '2', 'prefix': prefix, 'delimiter': '/',
            'max-keys': str(max_keys)})
        url = f'{self.endpoint}/{bucket}?{q}'
        with urllib.request.urlopen(url, timeout=60) as resp:
            root = ElementTree.fromstring(resp.read())

        def strip(tag):
            return tag.split('}', 1)[-1]
        keys, dirs = [], []
        for el in root:
            if strip(el.tag) == 'Contents':
                k = s = None
                for c in el:
                    if strip(c.tag) == 'Key':
                        k = c.text
                    elif strip(c.tag) == 'Size':
                        s = int(c.text)
                keys.append((k, s or 0))
            elif strip(el.tag) == 'CommonPrefixes':
                for c in el:
                    if strip(c.tag) == 'Prefix':
                        dirs.append(c.text)
        return keys, dirs

    def ls(self, path: str) -> List[FileStatus]:
        bucket, key = _split(path)
        prefix = key.rstrip('/') + '/' if key else ''
        keys, dirs = self._list(bucket, prefix)
        out = [FileStatus(path=f's3://{bucket}/{k}', size=s, is_dir=False,
                          modification_time=None) for k, s in keys]
        out.extend(FileStatus(path=f's3://{bucket}/{d.rstrip("/")}', size=0,
                              is_dir=True, modification_time=None)
                   for d in dirs)
        if not out and not self.is_file(path):
            raise FileNotFoundError(path)
        return out

    def mkdir(self, path: str) -> None:
        pass   # object stores have no directories

    def remove(self, path: str) -> None:
        bucket, key = _split(path)
        self._req('DELETE', bucket, key).read()

    def rmtree(self, path: str) -> None:
        bucket, key = _split(path)
        prefix = key.rstrip('/') + '/' if key else ''
        while True:
            keys, dirs = self._list(bucket, prefix)
            for d in dirs:
                self.rmtree(f's3://{bucket}/{d}')
            if not keys:
                break
            for k, _ in keys:
                self._req('DELETE', bucket, k).read()
        if self.is_file(path):
            self.remove(path)

    def copy(self, src: str, dest: str) -> None:
        if src.startswith('s3://') and dest.startswith('s3://'):
            sb, sk = _split(src)
            db, dk = _split(dest)
            self._req('PUT', db, dk,
                      headers={'x-amz-copy-source': f'/{sb}/{sk}'}).read()
            return
        if src.startswith('s3://'):
            with self.open(src, 'rb') as f, open(dest, 'wb') as g:
                g.write(f.read())
            return
        with open(src, 'rb') as f, self.open(dest, 'wb') as g:
            g.write(f.read())
