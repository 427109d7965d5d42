"""The one traffic generator: statements drawn from a mix file and the
query templates, and the closed loop of clients that sends them.

A mix (``traffic/<mix>.json``) names its templates and how they are drawn:

- ``"order": "cycle"``: fresh statements' templates in the listed order,
  again and again; ``"shuffled"``: every template once a round, each round
  in a seeded order;
- ``"repeat_share"`` and ``"repeat_window"``: the share of sends that
  re-send one of the last ``repeat_window`` distinct statements any client
  has sent in this run, drawn uniformly, whether or not its first send has
  been answered; the share holds exactly in each block of sends (3 of 5
  for 0.6), in a seeded order (a repeat due before any send is a fresh
  send);
- ``"clients"``: closed-loop clients, one connection and one thread each,
  zero think time; ``"application"`` is each client's WLM application, and
  ``"resource_plan"`` the DDL that set-up runs before them.

A fresh statement draws the template's substitution parameters from the
seed (``queries/<name>.json``: ``{"domain": d}`` a value of the
generator's domain ``d``, with ``"count": k`` k distinct ones; ``{"int":
[lo, hi]}`` a whole number; ``{"add": [p, k]}`` parameter p plus k), never
one this run has sent or warmed up with; where a template's parameters run
out, its statements may come again (counted in ``reused``).  Every
seed gives each template and the repeats the same share of the sends, in
another order, so that the seed does not change the amount of work; which
client sends which statement depends on timing.
"""
from __future__ import annotations

import collections
import threading
import time
from fractions import Fraction
from typing import Callable, List, NamedTuple, Optional

from .reference.ssbgen import domains, rng_for

DRAWS_PER_STATEMENT = 200  # attempts at an unseen statement before reuse
MAX_BLOCK = 20  # sends in a block that holds the repeat share exactly


class Statement(NamedTuple):
    template: str
    sql: str
    params: dict


class Record(NamedTuple):
    """One query of the window, as its client saw it."""
    statement: Statement
    sent: float       # host clock (time.perf_counter) at the send
    done: float       # at its last row, or at its failure
    rows: Optional[list]
    info: dict
    error: Optional[str]
    trace: Optional[dict]   # Chrome trace of obs.tracing, when on


def draw_params(params: dict, rng, values: dict) -> dict:
    out = {}
    for name, how in params.items():
        if "domain" in how:
            dom = values[how["domain"]]
            if "count" in how:
                picks = rng.choice(len(dom), how["count"], replace=False)
                out[name] = [dom[i] for i in sorted(picks)]
            else:
                out[name] = dom[int(rng.integers(len(dom)))]
        elif "int" in how:
            lo, hi = how["int"]
            out[name] = int(rng.integers(lo, hi + 1))
        elif "add" in how:
            base, k = how["add"]
            out[name] = out[base] + k
        else:
            raise ValueError(f"parameter {name}: unknown kind {how}")
    return out


class StatementStream:
    """The mix's statements in send order; ``next`` may be called from any
    client thread."""

    def __init__(self, mix: dict, templates: dict, seed: int):
        self.mix = mix
        self.templates = {name: templates[name] for name in mix["templates"]}
        self._rng = rng_for(seed, "traffic")
        self._values = domains()
        self._seen = {name: set() for name in self.templates}
        # the last distinct statements sent, the repeats' pool, oldest
        # send first
        self._recent = collections.OrderedDict()
        self._window = mix.get("repeat_window", 0)
        self._lock = threading.Lock()
        self._fresh = 0
        self._repeats = []   # this block's send-or-repeat decisions
        self._round = []     # this round's templates, "shuffled" order
        self.reused = 0

    def fresh(self, name: str) -> Statement:
        tpl = self.templates[name]
        seen = self._seen[name]
        for _ in range(DRAWS_PER_STATEMENT):
            params = draw_params(tpl["params"], self._rng, self._values)
            sql = tpl["sql"].format(**params)
            if sql not in seen:
                break
        else:
            self.reused += 1
        seen.add(sql)
        return Statement(name, sql, params)

    def warmup(self) -> List[Statement]:
        """Statements for set-up, one per template; the window never sends
        them."""
        return [self.fresh(n) for n in self.templates]

    def _repeat_now(self) -> bool:
        """The next decision of a block in which exactly ``repeat_share`` of
        the sends are repeats, in a seeded order."""
        share = Fraction(self.mix.get("repeat_share", 0)).limit_denominator(
            MAX_BLOCK)
        if not share:
            return False
        if not self._repeats:
            block = [True] * share.numerator + \
                [False] * (share.denominator - share.numerator)
            self._repeats = [bool(b) for b in self._rng.permutation(block)]
        return self._repeats.pop()

    def _sent(self, st: Statement) -> Statement:
        """``st`` becomes the pool's newest statement."""
        if self._window:
            self._recent.pop(st.sql, None)
            self._recent[st.sql] = st
            if len(self._recent) > self._window:
                self._recent.popitem(last=False)
        return st

    def next(self) -> Statement:
        with self._lock:
            if self._repeat_now() and self._recent:
                pool = list(self._recent.values())
                return self._sent(pool[int(self._rng.integers(len(pool)))])
            names = list(self.templates)
            if self.mix["order"] == "cycle":
                name = names[self._fresh % len(names)]
            else:
                if not self._round:
                    self._round = [str(n) for n in
                                   self._rng.permutation(names)]
                name = self._round.pop()
            self._fresh += 1
            return self._sent(self.fresh(name))


def closed_loop(stream: StatementStream, clients: int, seconds: float,
                send: Callable, timeout_s: float) -> tuple:
    """``clients`` threads, each sending ``stream``'s next statement
    through ``send(client, statement, timeout_s)`` as soon as its last one
    returned, until ``seconds`` after the first send.  ``send`` returns
    (rows, info, trace) or raises.  Returns (window start, window end, the
    records in completion order): the window starts at the first send and
    ends when the last query sent has returned its last row."""
    records: List[Record] = []
    lock = threading.Lock()
    start = threading.Barrier(clients + 1)
    t0 = [0.0]

    def client(k: int) -> None:
        start.wait()
        while time.perf_counter() - t0[0] < seconds:
            st = stream.next()
            sent = time.perf_counter()
            try:
                rows, info, trace = send(k, st, timeout_s)
                rec = Record(st, sent, time.perf_counter(), rows, info, None,
                             trace)
            except Exception as exc:  # a failed query is a result
                rec = Record(st, sent, time.perf_counter(), None, {},
                             f"{type(exc).__name__}: {exc}", None)
            with lock:
                records.append(rec)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    t0[0] = time.perf_counter()
    start.wait()
    for t in threads:
        t.join()
    first = min((r.sent for r in records), default=t0[0])
    return first, max((r.done for r in records), default=first), records
