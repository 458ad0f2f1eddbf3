"""Retry/backoff helpers with the reference `hailtop.utils` contract
(reference hail/python/hailtop/utils/utils.py:728-900): AWS-style
exponential backoff with full jitter, response-returning retry wrappers,
and a plain requests session for external (non-Hail) endpoints."""

from __future__ import annotations

import asyncio
import logging
import random

log = logging.getLogger(__name__)

DEFAULT_BASE_DELAY_MS = 1_000
DEFAULT_MAX_DELAY_MS = 30_000
LOG_2_MAX_MULTIPLIER = 30

RETRYABLE_HTTP_STATUS_CODES = {408, 429, 500, 502, 503, 504}


def delay_ms_for_try(tries: int, base_delay_ms: int = DEFAULT_BASE_DELAY_MS,
                     max_delay_ms: int = DEFAULT_MAX_DELAY_MS) -> int:
    multiplier = 1 << min(tries, LOG_2_MAX_MULTIPLIER)
    ceiling = base_delay_ms * multiplier
    proposed = ceiling // 2 + random.randrange(ceiling // 2 + 1)
    return min(proposed, max_delay_ms)


async def sleep_before_try(tries: int,
                           base_delay_ms: int = DEFAULT_BASE_DELAY_MS,
                           max_delay_ms: int = DEFAULT_MAX_DELAY_MS):
    await asyncio.sleep(
        delay_ms_for_try(tries, base_delay_ms, max_delay_ms) / 1000.0)


def sync_sleep_before_try(tries: int,
                          base_delay_ms: int = DEFAULT_BASE_DELAY_MS,
                          max_delay_ms: int = DEFAULT_MAX_DELAY_MS):
    import time
    time.sleep(delay_ms_for_try(tries, base_delay_ms, max_delay_ms) / 1000.0)


def retry_response_returning_functions(fun, *args, **kwargs):
    """Retry a requests-style call while it returns retryable statuses
    (reference utils.py:866)."""
    tries = 0
    response = fun(*args, **kwargs)
    while response.status_code in RETRYABLE_HTTP_STATUS_CODES:
        tries += 1
        if tries % 10 == 0:
            log.warning(f'encountered {tries} bad status codes, most recent: '
                        f'{response.status_code}')
        sync_sleep_before_try(tries)
        response = fun(*args, **kwargs)
    return response


def external_requests_client_session(headers=None, timeout: int = 5):
    """A requests.Session with retrying adapters for non-Hail endpoints
    (reference utils.py:878)."""
    import requests
    session = requests.Session()
    adapter = requests.adapters.HTTPAdapter(max_retries=1)
    session.mount('http://', adapter)
    session.mount('https://', adapter)
    if headers:
        session.headers = headers
    session.request = _with_timeout(session.request, timeout)
    return session


def _with_timeout(fn, timeout):
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        kwargs.setdefault('timeout', timeout)
        return fn(*args, **kwargs)
    return wrapper


async def retry_transient_errors(f, *args, **kwargs):
    """await f(*args, **kwargs), retrying transient aiohttp errors
    (reference utils.py retry_transient_errors)."""
    import aiohttp
    tries = 0
    while True:
        try:
            return await f(*args, **kwargs)
        except aiohttp.ClientResponseError as e:
            if e.status not in RETRYABLE_HTTP_STATUS_CODES or tries >= 10:
                raise
        except (aiohttp.ClientConnectionError, asyncio.TimeoutError):
            if tries >= 10:
                raise
        tries += 1
        await sleep_before_try(tries)
