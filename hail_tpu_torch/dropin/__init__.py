"""Run a Hail pipeline unmodified on the port: `import hail as hl` and
`import hailtop.batch as hb` resolve to `hail_tpu_torch`.

    python -m hail_tpu_torch.dropin [--device cpu|cuda] pipeline.py [args]

or, in a process that has imported neither `hail` nor `hailtop` yet:

    import hail_tpu_torch.dropin
    hail_tpu_torch.dropin.install()
    import hail as hl

This directory holds the port's own copies of the alias packages `hail`
(with its submodule aliases, the harness imports and the explanatory
`hail.backend.spark_backend` stub), `hailtop` (with `batch_client`),
`pyspark` and `avro` (the repo's alias packages, which forward to
`hail_tpu`, made to forward to this package). `install` puts it first on
`sys.path`, ahead of those. A pipeline's `hl.init()` that names no device
runs on the card, as the port's entry points do, unless `device` says
otherwise.
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))


def _ours(mod) -> bool:
    path = getattr(mod, '__file__', None) or ''
    return os.path.abspath(path).startswith(_HERE + os.sep)


def install(device=None) -> None:
    """Put the drop-in's `hail`, `hailtop`, `pyspark` and `avro` first on
    `sys.path`. `device` ('cuda' or 'cpu'): the device of an `hl.init()`
    that names none (by default the card). Raises, and changes nothing, if
    a `hail` or `hailtop` other than the drop-in's is loaded already: a
    later `import hail` would return it."""
    loaded = [name for name in ('hail', 'hailtop')
              if sys.modules.get(name) is not None
              and not _ours(sys.modules[name])]
    if loaded:
        where = ', '.join(
            f'{n!r} from {getattr(sys.modules[n], "__file__", None)}'
            for n in loaded)
        raise RuntimeError(f'hail_tpu_torch.dropin.install(): {where} is '
                           'loaded already, so `import hail` would not '
                           'reach the port')
    if device is not None:
        from .. import context
        context._default_device = device
    if _HERE in sys.path:
        sys.path.remove(_HERE)
    sys.path.insert(0, _HERE)
