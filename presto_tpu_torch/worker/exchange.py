"""HTTP exchange client: pulls SerializedPages from upstream task buffers.

The analog of the reference's ExchangeClient/PageBufferClient
(presto-main-base/.../operator/ExchangeClient.java:72) and the native
PrestoExchangeSource (presto_cpp/main/PrestoExchangeSource.cpp:171).

Two layers:

  * `pull_pages` — the per-location protocol loop: GET {location}/{token}
    -> acknowledge -> repeat until the complete flag, then DELETE the
    buffer.  Transient transport failures RESUME from the last delivered
    token under an exponential-backoff-with-jitter loop bounded by a real
    error budget (reference exchange.max-error-duration).  When the budget
    expires — or the producer task vanishes outright (404) — a typed
    ExchangeLostError carries the producer location upward so the
    coordinator can map it back to the producing task and retry that task
    instead of failing the query.

  * `ExchangeClient` — the concurrent consumer: one puller per upstream
    location (capped by exchange.client-threads), each running the
    protocol loop above with its OWN token/backoff state, feeding a single
    bounded arrival-order queue (exchange.max-buffer-size bytes).  Pullers
    park when the buffer is full (producer backpressure), acknowledges are
    fire-and-forget on a separate thread, and page deserialization/LZ4
    decode happens IN the puller threads — so decode parallelizes across
    producers and the consuming pipeline computes on page k while pages
    k+1... are in flight.  Every puller sends an X-Presto-Max-Size cap so
    producers coalesce tiny pages into ~max-response-size bodies.

Fault-tolerance semantics are unchanged under concurrency: per-location
token resume, 404/410 -> ExchangeLostError (producer lineage), 500 ->
RemoteTaskError with the producer's [ERROR_TYPE] tag, and exactly-once via
replayable retained buffers (a restarted consumer re-creates the client
and replays every location from token 0).
"""
from __future__ import annotations

import collections
import queue
import random
import re
import struct
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Iterator, List, Optional

from ..common.errors import (ExchangeLostError, RemoteTaskError,
                             is_retryable_type, parse_error_type)
from ..common.locks import OrderedCondition, OrderedLock
from ..common.page import Page
from ..common.serde import DEFAULT_CODEC, deserialize_page, deserialize_pages

DEFAULT_MAX_WAIT_S = 1.0
REQUEST_TIMEOUT_S = 30.0
DEFAULT_MAX_ERROR_DURATION_S = 60.0
DEFAULT_CLIENT_THREADS = 4            # exchange.client-threads
DEFAULT_MAX_BUFFER_BYTES = 32 << 20   # exchange.max-buffer-size
DEFAULT_MAX_RESPONSE_BYTES = 1 << 20  # exchange.max-response-size
_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 2.0

_PAGE_HEADER = struct.Struct("<ibiiq")


class ExchangeAbortedError(RuntimeError):
    """Raised through should_abort when the consuming task is already
    terminal: the pull must stop, not drain a doomed query."""


class _Stop(BaseException):
    """Internal puller-thread unwind on client close (BaseException so it
    cannot be swallowed by a broad `except Exception`)."""


class _Relocate(BaseException):
    """Internal puller unwind when a location was superseded by a task
    retry (update_locations): the puller re-resolves the location and
    resumes the SAME stream at its delivered token."""

    def __init__(self, location: str):
        self.location = location


# buffer identity inside a results location:
# http://host:port/v1/task/{taskId}/results/{bufferId}
_LOCATION_KEY = re.compile(r"/v1/task/([^/\s]+)/results/(\d+)")
_RETRY_SUFFIX = re.compile(r"\.r\d+$")


def _location_key(location: str):
    """(base task lineage, buffer id) — stable across retry attempts, so
    an old attempt's location matches its replacement's."""
    m = _LOCATION_KEY.search(location)
    if not m:
        return location
    return _RETRY_SUFFIX.sub("", m.group(1)), m.group(2)


def _request(url: str, method: str = "GET",
             timeout: float = REQUEST_TIMEOUT_S, headers: dict = None):
    from .auth import outbound_headers, urlopen_internal
    h = outbound_headers()
    if headers:
        h.update(headers)
    req = urllib.request.Request(url, method=method, headers=h)
    return urlopen_internal(req, timeout=timeout)


class ExchangeMetrics:
    """Process-wide exchange counters for /v1/metrics (one worker per
    process in deployment; tests reset() before asserting).  The buffered
    gauge aggregates across every live ExchangeClient in the process, so
    its peak proves backpressure actually bounded resident bytes."""

    def __init__(self):
        # rank 100: metrics registries are leaf locks
        self._lock = OrderedLock("metrics:exchange", 100)  # lint: guarded-by(_lock)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.pages = 0
            self.bytes = 0                # wire (possibly compressed) bytes
            self.uncompressed_bytes = 0
            self.responses = 0
            self.pull_wall_s = 0.0        # HTTP request walls, all pullers
            self.decode_wall_s = 0.0      # deserialize/decompress walls
            self.wait_wall_s = 0.0        # consumer blocked on empty buffer
            self.drain_wall_s = 0.0       # client open -> close
            self.buffered_bytes = 0
            self.buffered_bytes_peak = 0
            self.clients = 0

    def on_page(self, nbytes: int, uncompressed: int,
                decode_wall_s: float) -> None:
        with self._lock:
            self.pages += 1
            self.bytes += nbytes
            self.uncompressed_bytes += uncompressed
            self.decode_wall_s += decode_wall_s

    def on_response(self, wall_s: float) -> None:
        with self._lock:
            self.responses += 1
            self.pull_wall_s += wall_s

    def buffered_delta(self, delta: int) -> None:
        with self._lock:
            self.buffered_bytes += delta
            if self.buffered_bytes > self.buffered_bytes_peak:
                self.buffered_bytes_peak = self.buffered_bytes

    def on_client_close(self, wait_wall_s: float, drain_wall_s: float
                        ) -> None:
        with self._lock:
            self.clients += 1
            self.wait_wall_s += wait_wall_s
            self.drain_wall_s += drain_wall_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "pages": self.pages, "bytes": self.bytes,
                "uncompressed_bytes": self.uncompressed_bytes,
                "responses": self.responses,
                "pull_wall_s": self.pull_wall_s,
                "decode_wall_s": self.decode_wall_s,
                "wait_wall_s": self.wait_wall_s,
                "drain_wall_s": self.drain_wall_s,
                "buffered_bytes": self.buffered_bytes,
                "buffered_bytes_peak": self.buffered_bytes_peak,
                "clients": self.clients,
            }


EXCHANGE_METRICS = ExchangeMetrics()


def _pull_rounds(location: str,
                 max_error_duration_s: float = DEFAULT_MAX_ERROR_DURATION_S,
                 should_abort: Optional[Callable[[], None]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 max_response_bytes: Optional[int] = None,
                 acknowledge: Optional[Callable[[str], None]] = None,
                 on_round: Optional[Callable[[float], None]] = None,
                 start_token: int = 0,
                 park_on_failure: bool = False,
                 on_token: Optional[Callable[[int], None]] = None,
                 ) -> Iterator[bytes]:
    """The per-location protocol loop, yielding each non-empty response
    BODY (one or more concatenated SerializedPages).  Handles token
    resume, the budgeted jittered backoff, acknowledges (via the
    `acknowledge` callback when given, else inline best-effort), and the
    final DELETE.  `sleep` is injectable so a closing client can interrupt
    a backoff wait.

    `start_token` resumes a relocated stream mid-way (task retry under
    retry-policy=task: the replacement attempt replays the same durable
    spool, so tokens line up).  With `park_on_failure` a RETRYABLE
    producer failure (500 with a retryable [ERROR_TYPE], 404/410 task
    loss) downgrades to the budgeted backoff instead of raising — the
    coordinator will replace the producer and redirect this pull, so the
    consumer survives the producer's death (fault-tolerant mode's
    decoupled lifetimes).  Non-retryable producer errors still propagate
    immediately."""
    token = start_token
    error_since: Optional[float] = None
    attempt = 0
    extra = ({"X-Presto-Max-Size": str(int(max_response_bytes))}
             if max_response_bytes else None)
    while True:
        if should_abort is not None:
            should_abort()
        url = f"{location}/{token}?maxWaitMs={int(DEFAULT_MAX_WAIT_S * 1000)}"
        t0 = time.perf_counter()
        try:
            with _request(url, headers=extra) as resp:
                complete = resp.headers.get(
                    "X-Presto-Buffer-Complete", "false") == "true"
                # reference name first (PrestoHeaders.PRESTO_PAGE_NEXT_TOKEN
                # = X-Presto-Page-End-Sequence-Id), repo alias as fallback
                next_token = int(
                    resp.headers.get("X-Presto-Page-End-Sequence-Id")
                    or resp.headers.get("X-Presto-Page-Next-Token", token))
                body = resp.read()
            error_since, attempt = None, 0
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            if e.code in (404, 410):
                if park_on_failure:
                    # the producer attempt is gone but a replacement is
                    # coming: wait (budgeted) for the redirect
                    error_since, attempt = _backoff(
                        location, token, error_since, attempt,
                        max_error_duration_s, e, sleep=sleep)
                    continue
                # the producer task is GONE (worker restarted and lost its
                # task registry): not transient — the task must be rebuilt
                raise ExchangeLostError(
                    location, token,
                    f"exchange source {location} vanished ({e.code}) at "
                    f"token {token}: producer task lost") from e
            if e.code == 503:
                # draining/overloaded producer: transient, budgeted retry
                error_since, attempt = _backoff(
                    location, token, error_since, attempt,
                    max_error_duration_s, e, sleep=sleep)
                continue
            if (park_on_failure
                    and is_retryable_type(parse_error_type(detail))):
                # retryable producer failure under retry-policy=task: the
                # coordinator retries THAT task alone; this consumer parks
                # and resumes against the replacement attempt
                error_since, attempt = _backoff(
                    location, token, error_since, attempt,
                    max_error_duration_s, e, sleep=sleep)
                continue
            # 500 carries a producer-side failure: propagate typed (the
            # [ERROR_TYPE] tag in the detail decides retryability upstream)
            raise RemoteTaskError(location, detail) from e
        except (urllib.error.URLError, TimeoutError, ConnectionError,
                OSError) as e:
            error_since, attempt = _backoff(
                location, token, error_since, attempt,
                max_error_duration_s, e, sleep=sleep)
            continue
        if on_round is not None:
            on_round(time.perf_counter() - t0)
        if body:
            yield body
        if next_token != token:
            ack_url = f"{location}/{next_token}/acknowledge"
            if acknowledge is not None:
                acknowledge(ack_url)     # fire-and-forget (ack thread)
            else:
                try:
                    _request(ack_url).close()
                except (urllib.error.URLError, TimeoutError, OSError):
                    pass  # acknowledge is an optimization; pull re-fetches
            token = next_token
            if on_token is not None:
                on_token(next_token)
        if complete:
            try:
                _request(location, method="DELETE").close()
            except (urllib.error.URLError, TimeoutError, OSError):
                pass
            return


def pull_pages(location: str, codec: str = DEFAULT_CODEC,
               max_error_duration_s: float = DEFAULT_MAX_ERROR_DURATION_S,
               should_abort: Optional[Callable[[], None]] = None,
               max_response_bytes: Optional[int] = None
               ) -> Iterator[Page]:
    """Stream every page from one upstream buffer location
    (http://host:port/v1/task/{taskId}/results/{bufferId}), sequentially.
    `codec` decodes COMPRESSED pages; it is cluster config shared with the
    producer, like the reference exchange.compression-codec.

    `should_abort` is polled once per pull round (it raises to abort).
    This is the single-location building block; multi-location consumers
    use ExchangeClient for concurrency + bounded buffering."""
    for body in _pull_rounds(location,
                             max_error_duration_s=max_error_duration_s,
                             should_abort=should_abort,
                             max_response_bytes=max_response_bytes):
        for page in deserialize_pages(body, codec=codec):
            yield page


def _backoff(location: str, token: int, error_since: Optional[float],
             attempt: int, max_error_duration_s: float,
             cause: Exception,
             sleep: Callable[[float], None] = time.sleep) -> tuple:
    """One budgeted retry step: raise ExchangeLostError once errors have
    persisted past the budget, else sleep exp-backoff + jitter (reference
    PageBufferClient backoff under exchange.max-error-duration)."""
    now = time.monotonic()
    if error_since is None:
        error_since = now
    if now - error_since >= max_error_duration_s:
        raise ExchangeLostError(
            location, token,
            f"exchange source {location} unreachable for "
            f"{now - error_since:.1f}s (budget {max_error_duration_s}s) "
            f"at token {token}: {cause}") from cause
    delay = min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * (2 ** attempt))
    # full jitter keeps a fleet of consumers from re-probing in lockstep
    sleep(delay * (0.5 + random.random() * 0.5))
    return error_since, attempt + 1


class ExchangeClient:
    """Concurrent multi-location exchange consumer (ExchangeClient.java:72
    shape): `pages()` yields decoded pages in ARRIVAL order across all
    locations while puller threads keep the bounded buffer full.

    Backpressure: a puller parks before enqueueing a page that would push
    buffered bytes past `max_buffer_bytes` (a page is always admitted into
    an EMPTY buffer so one oversized page cannot deadlock the stream) —
    so resident bytes stay <= max(max_buffer_bytes, largest page).

    Errors from any puller (ExchangeLostError / RemoteTaskError / whatever
    `should_abort` raises) surface on the consumer immediately — a stalled
    sibling location cannot delay failure propagation."""

    def __init__(self, locations: List[str], codec: str = DEFAULT_CODEC,
                 max_error_duration_s: float = DEFAULT_MAX_ERROR_DURATION_S,
                 should_abort: Optional[Callable[[], None]] = None,
                 client_threads: int = DEFAULT_CLIENT_THREADS,
                 max_buffer_bytes: int = DEFAULT_MAX_BUFFER_BYTES,
                 max_response_bytes: int = DEFAULT_MAX_RESPONSE_BYTES,
                 stats=None, park_on_failure: bool = False):
        self._codec = codec
        self._max_error_s = max_error_duration_s
        self._should_abort = should_abort
        self._park = park_on_failure
        # task-retry redirection (update_locations): old location -> new,
        # plus the delivered-token high-water mark per live location so a
        # redirected pull resumes instead of replaying delivered pages
        self._redirect: Dict[str, str] = {}
        self._loc_tokens: Dict[str, int] = {}
        self._max_buffer = max(1, int(max_buffer_bytes))
        self._max_response = int(max_response_bytes) or None
        self._stats = stats               # utils.runtime_stats.RuntimeStats
        # rank 18: the exchange buffer lock nests only into the metrics
        # leaves; pullers and the consumer hold nothing above it
        self._cond = OrderedCondition(
            "exchange-client", 18)  # lint: guarded-by(_cond)
        self._queue: "collections.deque" = collections.deque()
        self._buffered = 0
        self._buffered_peak = 0
        self._remaining = len(locations)  # locations not yet complete
        self._error: Optional[BaseException] = None
        self._closed = False
        self._stop_event = threading.Event()
        # client-level counters (flushed into `stats` at close)
        self._pull_wall = 0.0
        self._decode_wall = 0.0
        self._wait_wall = 0.0
        self._pages = 0
        self._bytes = 0
        self._uncompressed = 0
        self._t0 = time.perf_counter()
        self._location_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._known = set(locations)      # every location we may pull
        for loc in locations:
            self._location_q.put((loc, 0))
        self._ack_q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._threads: List[threading.Thread] = []
        if locations:
            threading.Thread(target=self._ack_loop, daemon=True,
                             name="exchange-ack").start()
            n = max(1, min(int(client_threads), len(locations)))
            for i in range(n):
                t = threading.Thread(target=self._puller, daemon=True,
                                     name=f"exchange-puller-{i}")
                t.start()
                self._threads.append(t)

    # -- puller side -------------------------------------------------------
    def _abort_check(self) -> None:
        if self._closed or self._error is not None:
            raise _Stop()
        if self._should_abort is not None:
            self._should_abort()

    def _abort_check_loc(self, location: str) -> None:
        """Per-location round check: close/error/abort as usual, plus the
        relocation signal — a superseded location unwinds its puller so it
        can resume against the replacement attempt."""
        self._abort_check()
        with self._cond:
            if location in self._redirect:
                raise _Relocate(location)

    def _resolve_location(self, location: str) -> str:
        """Follow the redirect chain to the newest attempt's location."""
        with self._cond:
            seen = set()
            while location in self._redirect and location not in seen:
                seen.add(location)
                location = self._redirect[location]
            return location

    def update_locations(self, new_locations: List[str]) -> None:
        """Coordinator task-retry: map every known location whose (base
        lineage, buffer id) matches a replacement onto the new attempt's
        location.  Live pullers unwind via _Relocate at their next round
        and resume the stream at its delivered token; queued locations
        resolve at dequeue.  No-op for locations already current."""
        with self._cond:
            if self._closed:
                return
            by_key = {_location_key(loc): loc for loc in new_locations}
            for old in list(self._known):
                new = by_key.get(_location_key(old))
                if new is not None and new != old:
                    self._redirect[old] = new
                    self._known.add(new)
            self._cond.notify_all()

    def _sleep(self, delay: float) -> None:
        if self._stop_event.wait(delay):
            raise _Stop()

    def _on_round(self, wall_s: float) -> None:
        with self._cond:
            self._pull_wall += wall_s
        EXCHANGE_METRICS.on_response(wall_s)

    def _note_token(self, location: str, token: int) -> None:
        with self._cond:
            self._loc_tokens[location] = token

    def _puller(self) -> None:
        """Drain locations off the shared queue (cap: client_threads
        pullers active at once) until none remain; each location resumes
        from its own token with its own backoff budget.  A relocation
        (task retry) unwinds the location's pull and resumes the same
        stream against the replacement attempt at its delivered token."""
        try:
            while True:
                try:
                    loc, tok = self._location_q.get_nowait()
                except queue.Empty:
                    return
                while True:
                    loc = self._resolve_location(loc)
                    self._note_token(loc, tok)
                    try:
                        for body in _pull_rounds(
                                loc,
                                max_error_duration_s=self._max_error_s,
                                should_abort=lambda l=loc:
                                    self._abort_check_loc(l),
                                sleep=self._sleep,
                                max_response_bytes=self._max_response,
                                acknowledge=self._ack_q.put,
                                on_round=self._on_round,
                                start_token=tok,
                                park_on_failure=self._park,
                                on_token=lambda t, l=loc:
                                    self._note_token(l, t)):
                            self._decode_and_offer(body)
                        break                    # stream complete
                    except _Relocate:
                        with self._cond:
                            tok = self._loc_tokens.get(loc, tok)
                        continue                 # resume on new attempt
                with self._cond:
                    self._remaining -= 1
                    if self._remaining <= 0:
                        self._cond.notify_all()
        except _Stop:
            return
        except BaseException as e:
            self._fail(e)

    def _decode_and_offer(self, body: bytes) -> None:
        """Deserialize (and LZ4-decode) each page IN the puller thread,
        then enqueue under backpressure."""
        view = memoryview(body)
        pos, n = 0, len(view)
        while pos < n:
            _, _, uncompressed, _, _ = _PAGE_HEADER.unpack_from(view, pos)
            t0 = time.perf_counter()
            page, nxt = deserialize_page(view, pos, codec=self._codec)
            dt = time.perf_counter() - t0
            nbytes = nxt - pos
            pos = nxt
            with self._cond:
                self._decode_wall += dt
                self._uncompressed += uncompressed
            EXCHANGE_METRICS.on_page(nbytes, uncompressed, dt)
            self._offer(page, nbytes)

    def _offer(self, page: Page, nbytes: int) -> None:
        with self._cond:
            while (self._buffered
                   and self._buffered + nbytes > self._max_buffer
                   and self._error is None and not self._closed):
                self._cond.wait(0.2)     # producer backpressure: park
            if self._closed or self._error is not None:
                raise _Stop()
            self._queue.append((page, nbytes))
            self._buffered += nbytes
            if self._buffered > self._buffered_peak:
                self._buffered_peak = self._buffered
            self._pages += 1
            self._bytes += nbytes
            self._cond.notify_all()
        EXCHANGE_METRICS.buffered_delta(nbytes)

    def _fail(self, exc: BaseException) -> None:
        with self._cond:
            if self._error is None:
                self._error = exc
            self._cond.notify_all()

    def _ack_loop(self) -> None:
        """Fire-and-forget acknowledges: frees producer buffer memory off
        the pull critical path (the reference sends these async too).
        The pull is BOUNDED so a lost wake token (close() racing the
        queue) can never wedge the thread past the stop flag."""
        while True:
            try:
                url = self._ack_q.get(timeout=0.5)
            except queue.Empty:
                if self._closed or self._stop_event.is_set():
                    return
                continue
            if url is None or self._closed:
                return
            try:
                _request(url, timeout=10.0).close()
            except (urllib.error.URLError, TimeoutError, OSError):
                pass  # optional: an unacked page is re-served, not lost

    # -- consumer side -----------------------------------------------------
    def pages(self) -> Iterator[Page]:
        """Arrival-order page stream; raises the first puller error (or
        whatever should_abort raises).  Closes the client when the
        generator is exhausted or closed."""
        try:
            while True:
                with self._cond:
                    while (not self._queue and self._error is None
                           and self._remaining > 0 and not self._closed):
                        if self._should_abort is not None:
                            self._should_abort()
                        t0 = time.perf_counter()
                        self._cond.wait(0.1)
                        self._wait_wall += time.perf_counter() - t0
                    if self._error is not None:
                        raise self._error
                    if self._queue:
                        page, nbytes = self._queue.popleft()
                        self._buffered -= nbytes
                        self._cond.notify_all()  # unpark parked pullers
                    else:            # complete (or closed underneath us)
                        if self._should_abort is not None:
                            self._should_abort()
                        return
                EXCHANGE_METRICS.buffered_delta(-nbytes)
                yield page
        finally:
            self.close()

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            leftover = self._buffered
            self._queue.clear()
            self._buffered = 0
            self._cond.notify_all()
        self._stop_event.set()
        self._ack_q.put(None)            # wake the ack thread so it exits
        if leftover:
            EXCHANGE_METRICS.buffered_delta(-leftover)
        drain_wall = time.perf_counter() - self._t0
        EXCHANGE_METRICS.on_client_close(self._wait_wall, drain_wall)
        if self._stats is not None:
            nano = 1e9
            self._stats.add("exchangeClientPullWallNanos",
                            self._pull_wall * nano, "NANO")
            self._stats.add("exchangeClientDecodeWallNanos",
                            self._decode_wall * nano, "NANO")
            self._stats.add("exchangeClientWaitWallNanos",
                            self._wait_wall * nano, "NANO")
            self._stats.add("exchangeClientDrainWallNanos",
                            drain_wall * nano, "NANO")
            self._stats.add("exchangeClientBytes", self._bytes, "BYTE")
            self._stats.add("exchangeClientUncompressedBytes",
                            self._uncompressed, "BYTE")
            self._stats.add("exchangeClientPages", self._pages, "NONE")
            self._stats.add("exchangeClientBufferedPeakBytes",
                            self._buffered_peak, "BYTE")

    @property
    def buffered_peak(self) -> int:
        with self._cond:
            return self._buffered_peak


def remote_page_reader(locations: List[str], codec: str = DEFAULT_CODEC,
                       max_error_duration_s: float =
                       DEFAULT_MAX_ERROR_DURATION_S,
                       should_abort: Optional[Callable[[], None]] = None,
                       client_threads: int = DEFAULT_CLIENT_THREADS,
                       max_buffer_bytes: int = DEFAULT_MAX_BUFFER_BYTES,
                       max_response_bytes: int = DEFAULT_MAX_RESPONSE_BYTES,
                       stats=None, park_on_failure: bool = False,
                       on_client: Optional[Callable] = None):
    """A TaskContext.remote_pages callable: pages from every upstream task
    feeding one RemoteSourceNode, pulled concurrently through an
    ExchangeClient.  `should_abort` raises to stop the pull early (worker
    tasks pass their own terminal-state check so a doomed query's remote
    sources stop instead of draining to completion).

    `locations` is held BY REFERENCE: a caller may mutate the list in
    place (task-retry redirection) and a later read() picks up the new
    locations.  `on_client` observes every client created so live pulls
    can be redirected too (ExchangeClient.update_locations);
    `park_on_failure` is the fault-tolerant consumer behavior (see
    _pull_rounds)."""
    def read() -> Iterator[Page]:
        client = ExchangeClient(
            list(locations), codec=codec,
            max_error_duration_s=max_error_duration_s,
            should_abort=should_abort, client_threads=client_threads,
            max_buffer_bytes=max_buffer_bytes,
            max_response_bytes=max_response_bytes, stats=stats,
            park_on_failure=park_on_failure)
        if on_client is not None:
            on_client(client)
        yield from client.pages()        # pages() closes the client
    return read
