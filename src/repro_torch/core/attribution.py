"""Per-request energy attribution with an exact conservation invariant.

``EnergyLedger`` splits every replica's metered joules across the requests
resident during each accounting interval:

* **prefill** energy goes to the prefilling stream (whole prompts and
  Sarathi-style chunks alike — the chunk's request is the only resident),
* **decode-block** energy is shared across the step's active slots by
  tokens produced — every alive row emits exactly one token per fused
  step, so the per-step split is an equal ``e / n_alive`` share,
* **idle** energy stays an explicit *unattributed pool* per replica
  (nobody asked for it; hiding it inside request rows would fake the
  per-request numbers).

Conservation is a hard invariant, not a tolerance check, and it is held
with *dual bookkeeping*:

1. **Float mirrors** — for each (replica, phase) the ledger accumulates
   the exact same float values, in the exact same order, as the engine's
   own ``prefill_energy_j`` / ``decode_energy_j`` / ``idle_energy_j``
   counters (both start at 0.0 and see the identical ``+=`` sequence), so
   ``phase_total()`` is **bitwise equal** to the ``ReplicaReport`` energy
   fields — including across kills (billing stops at the kill snapshot),
   preemption + recompute (recompute work is billed again, to the same
   rid: that *is* the request's true cost), and the cluster's report-time
   makespan idle top-up (mirrored through ``set_idle_topup``).
2. **Exact rational partition** — every billed float is exactly a
   rational, so each interval's energy is split in ``fractions.Fraction``
   space where ``sum(shares) == Fraction(e)`` holds *identically* (float
   regrouping is non-associative; rationals are).  Per replica,
   ``attributed + idle pool == everything billed`` is therefore true by
   construction, and ``verify_conservation`` checks both layers.

Migrated streams carry their partial ledger in ``StreamHandoff`` via
``export_carry`` / ``adopt_carry``: when exporter and importer share one
ledger object (the cluster installs a single shared ledger on every
replica) the carry is a no-op; across *distinct* ledgers the request's
accumulated energy seeds the adopter's record without touching the
adopter's per-replica conservation (the joules were metered elsewhere).

``CounterfactualPricer`` prices the same intervals at the hardware's max
frequency using the replica's own fitted latency/power models — through a
**noiseless clone** of the plant (``noise_sigma=0``, its own RNG), because
the live plant's methods advance its RNG and calling them off the billing
path would perturb the run (the step-identity invariant).  The
resulting ``energy_saved_j = e_at_fmax - e_metered`` is a model-based
estimate (floats, no exactness claim; near f_max the metered noise can
make single intervals slightly negative) of the paper's headline number,
live and per request.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["EnergyLedger", "CounterfactualPricer", "LedgerCarry",
           "verify_conservation"]

_PHASES = ("prefill", "decode", "idle")


@dataclasses.dataclass
class LedgerCarry:
    """A migrating stream's partial ledger (rides in ``StreamHandoff``).

    ``ledger`` is the *exporter's* ledger object: adoption into the same
    object is skipped (the record is already there — the cluster shares
    one ledger), adoption into a different ledger seeds the request's
    record without touching replica conservation."""
    ledger: "EnergyLedger"
    prefill: Fraction
    decode: Fraction
    saved_j: float
    tokens: int
    src: str


class _ReqRecord:
    __slots__ = ("rid", "prefill", "decode", "saved_j", "tokens",
                 "replicas", "carried_from")

    def __init__(self, rid: int):
        self.rid = rid
        self.prefill = Fraction(0)
        self.decode = Fraction(0)
        self.saved_j = 0.0
        self.tokens = 0
        self.replicas: List[str] = []
        self.carried_from: List[str] = []

    @property
    def energy(self) -> Fraction:
        return self.prefill + self.decode


class EnergyLedger:
    """Per-request energy attribution across one or many replicas.

    One instance may serve a whole cluster (that is how handoff carry
    stays a no-op); every record call names the billing replica."""

    def __init__(self):
        # float mirrors: same values, same order as the engine counters
        self._mirror: Dict[Tuple[str, str], float] = {}
        # exact rational layer
        self._frac_total: Dict[str, Fraction] = {}   # everything billed
        self._attr: Dict[str, Fraction] = {}         # request-attributed
        self._pool: Dict[str, Fraction] = {}         # idle pool
        self._saved: Dict[str, float] = {}           # counterfactual est.
        self._topup: Dict[str, float] = {}           # report-time idle
        self._req: Dict[int, _ReqRecord] = {}
        self.replicas: List[str] = []                # registration order

    # -- registration -------------------------------------------------------
    def register(self, replica: str) -> None:
        """Declare a replica so zero-energy replicas still verify/report."""
        if replica not in self._frac_total:
            self.replicas.append(replica)
            self._frac_total[replica] = Fraction(0)
            self._attr[replica] = Fraction(0)
            self._pool[replica] = Fraction(0)
            self._saved[replica] = 0.0
            for ph in _PHASES:
                self._mirror[(replica, ph)] = 0.0

    def _rec(self, rid: int) -> _ReqRecord:
        r = self._req.get(rid)
        if r is None:
            r = self._req[rid] = _ReqRecord(rid)
        return r

    # -- billing (called from the engines' existing accounting sites) -------
    def record_prefill(self, replica: str, rid: int, e_j: float, *,
                       tokens: int = 0, saved_j: float = 0.0) -> None:
        """Bill one prompt / one chunk of prefill: the prefilling stream is
        the interval's only resident, so it gets the whole amount."""
        self.register(replica)
        self._mirror[(replica, "prefill")] += e_j
        fe = Fraction(e_j)
        self._frac_total[replica] += fe
        self._attr[replica] += fe
        r = self._rec(rid)
        r.prefill += fe
        r.saved_j += saved_j
        r.tokens += tokens
        if replica not in r.replicas:
            r.replicas.append(replica)
        self._saved[replica] += saved_j

    def record_decode(self, replica: str, rids: Sequence[int], e_j: float,
                      *, saved_j: float = 0.0) -> None:
        """Bill one fused decode step shared by ``rids`` (the step's alive
        rows).  Each row produced exactly one token this step, so sharing
        by tokens produced is an equal split — done in Fraction space so
        the shares sum back to ``Fraction(e_j)`` identically."""
        self.register(replica)
        self._mirror[(replica, "decode")] += e_j
        fe = Fraction(e_j)
        self._frac_total[replica] += fe
        self._attr[replica] += fe
        n = len(rids)
        share = fe / n
        s_share = saved_j / n
        for rid in rids:
            r = self._rec(rid)
            r.decode += share
            r.saved_j += s_share
            r.tokens += 1
            if replica not in r.replicas:
                r.replicas.append(replica)
        self._saved[replica] += saved_j

    def record_idle(self, replica: str, e_j: float) -> None:
        """Bill an idle gap into the replica's unattributed pool."""
        self.register(replica)
        self._mirror[(replica, "idle")] += e_j
        fe = Fraction(e_j)
        self._frac_total[replica] += fe
        self._pool[replica] += fe

    def set_idle_topup(self, replica: str, e_j: float) -> None:
        """Idempotent report-time idle: the cluster bills alive replicas
        ``(makespan - vtime) * idle_power`` only when building a report
        (and may build several), so the ledger holds it in a slot that is
        overwritten, not accumulated.  It is pure idle-pool energy — the
        attribution identity is unaffected."""
        self.register(replica)
        self._topup[replica] = e_j

    # -- migration ----------------------------------------------------------
    def export_carry(self, replica: str, rid: int) -> LedgerCarry:
        """Snapshot a migrating request's accumulated attribution for its
        ``StreamHandoff``."""
        r = self._rec(rid)
        return LedgerCarry(ledger=self, prefill=r.prefill, decode=r.decode,
                           saved_j=r.saved_j, tokens=r.tokens, src=replica)

    def adopt_carry(self, carry: Optional[LedgerCarry], rid: int) -> None:
        """Merge a handed-off request's partial ledger.  No-op when the
        exporter billed into this very ledger (shared-ledger cluster);
        otherwise the amounts seed the request record only — replica
        conservation here is untouched because the joules were metered on
        the exporter."""
        if carry is None or carry.ledger is self:
            return
        r = self._rec(rid)
        r.prefill += carry.prefill
        r.decode += carry.decode
        r.saved_j += carry.saved_j
        r.tokens += carry.tokens
        r.carried_from.append(carry.src)

    # -- queries -------------------------------------------------------------
    def phase_total(self, replica: str, phase: str) -> float:
        """The float mirror for (replica, phase) — bitwise comparable with
        the ``ReplicaReport`` energy fields.  Idle includes the report-time
        makespan top-up exactly as the cluster row adds it (one ``+``)."""
        v = self._mirror.get((replica, phase), 0.0)
        if phase == "idle":
            t = self._topup.get(replica)
            if t is not None:
                v = v + t
        return v

    def request_energy_j(self, rid: int) -> float:
        r = self._req.get(rid)
        return float(r.energy) if r is not None else 0.0

    def request_saved_j(self, rid: int) -> float:
        r = self._req.get(rid)
        return r.saved_j if r is not None else 0.0

    def energy_by_rid(self) -> Dict[int, float]:
        return {rid: float(r.energy) for rid, r in self._req.items()}

    def saved_by_rid(self) -> Dict[int, float]:
        return {rid: r.saved_j for rid, r in self._req.items()}

    def replica_saved_j(self, replica: str) -> float:
        return self._saved.get(replica, 0.0)

    def saved_total_j(self) -> float:
        return sum(self._saved.values())

    def idle_pool_j(self, replica: Optional[str] = None) -> float:
        """Unattributed idle energy (pool + report-time top-up)."""
        if replica is not None:
            return float(self._pool.get(replica, Fraction(0))) \
                + self._topup.get(replica, 0.0)
        return sum(self.idle_pool_j(r) for r in self.replicas)

    def attributed_j(self, replica: Optional[str] = None) -> float:
        if replica is not None:
            return float(self._attr.get(replica, Fraction(0)))
        return sum(self.attributed_j(r) for r in self.replicas)

    def rows(self) -> List[Dict]:
        """Per-request attribution rows (the ``--attribution-out`` JSONL
        schema; see README "Energy attribution & alerts")."""
        out = []
        for rid in sorted(self._req):
            r = self._req[rid]
            out.append({
                "rid": rid,
                "prefill_j": float(r.prefill),
                "decode_j": float(r.decode),
                "energy_j": float(r.energy),
                "energy_saved_j": r.saved_j,
                "tokens": r.tokens,
                "replicas": list(r.replicas),
                "carried_from": list(r.carried_from),
            })
        return out

    # -- conservation --------------------------------------------------------
    def check_exact(self, replica: str) -> None:
        """The rational-layer identity: everything billed on ``replica``
        is either attributed to a request or in the idle pool — exactly."""
        total = self._frac_total.get(replica, Fraction(0))
        attr = self._attr.get(replica, Fraction(0))
        pool = self._pool.get(replica, Fraction(0))
        assert attr + pool == total, (
            f"{replica}: attributed {attr} + pool {pool} != billed {total} "
            f"(off by {float(total - attr - pool):.3e} J)")


def _field(row, name: str):
    if isinstance(row, dict):
        return row[name]
    return getattr(row, name)


def verify_conservation(ledger: EnergyLedger, rows) -> List[Dict]:
    """Check the full conservation invariant against backend report rows.

    ``rows`` is any iterable of mappings or objects exposing ``replica``
    (or ``name``), ``prefill_j``/``prefill_energy_j``, ``decode_j``/
    ``decode_energy_j`` and ``idle_j``/``idle_energy_j`` — duck-typed so
    ``core`` never imports a backend.  For every row this asserts

    1. the ledger's float mirrors equal the report fields **bitwise**, and
    2. the exact rational identity attributed + idle pool == billed.

    Returns per-replica summary dicts; raises AssertionError on the first
    violation.
    """
    def get(row, *names):
        for n in names:
            try:
                return _field(row, n)
            except (KeyError, AttributeError):
                continue
        raise KeyError(f"row {row!r} has none of {names}")

    out = []
    for row in rows:
        rep = get(row, "replica", "name")
        for phase, names in (("prefill", ("prefill_j", "prefill_energy_j")),
                             ("decode", ("decode_j", "decode_energy_j")),
                             ("idle", ("idle_j", "idle_energy_j"))):
            want = get(row, *names)
            got = ledger.phase_total(rep, phase)
            assert got == want, (
                f"{rep}/{phase}: ledger mirror {got!r} != report {want!r} "
                f"(diff {got - want:.3e} J — the mirrors must see the "
                f"identical float sequence as the engine counters)")
        ledger.check_exact(rep)
        out.append({
            "replica": rep,
            "attributed_j": ledger.attributed_j(rep),
            "idle_pool_j": ledger.idle_pool_j(rep),
            "energy_saved_j": ledger.replica_saved_j(rep),
        })
    return out


class CounterfactualPricer:
    """Price accounting intervals at the hardware's max frequency.

    Built on a **noiseless clone** of the replica's plant
    (``dataclasses.replace(plant, noise_sigma=0.0)`` — its own RNG, noise
    factor exactly 1.0): the live plant's latency/power methods advance
    its RNG, so pricing through them off the billing path would perturb
    the run and break the step-identity invariant.  ``saved = priced -
    metered`` is an estimate; the baseline deliberately excludes the
    metered sample's noise draw.
    """

    def __init__(self, plant):
        self._plant = dataclasses.replace(plant, noise_sigma=0.0)
        self.f_max = float(plant.hw.f_max)

    def prefill_j(self, n_tokens: int) -> float:
        t = self._plant.prefill_latency(n_tokens, self.f_max)
        return t * self._plant.prefill_power(n_tokens, self.f_max, t)

    def decode_j(self, batch: int, ctx: float) -> float:
        t = self._plant.decode_step_latency(batch, ctx, self.f_max)
        return t * self._plant.decode_power(batch, ctx, self.f_max, t)
