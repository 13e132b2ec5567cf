"""Observability schema version (counterpart of ``evox_tpu/obs/version.py``).

One integer stamped into every artifact the obs plane exports — JSONL
event streams, Prometheus snapshot files, Chrome-trace JSON and flight
postmortem bundles.  The port exports the JAX package's schema, so the
value is the same; bump both together.
"""

from __future__ import annotations

# 2: flight-recorder postmortem bundles (manifest.json + flight.jsonl),
#    evox_segment_* / evox_device_* / evox_roofline_* gauges, Chrome-trace
#    counter tracks (ph:"C"), memory_analysis.json beside cost_analysis.json.
# 3: heartbeat "metrics" payload is the typed fleet_payload (counters/
#    gauges/histograms sections with bucket arrays, replacing the flat
#    dict), evox_slo_* burn-rate gauges, evox_journal_* histograms,
#    evox_fleet_host_up{process_index=} + stale="true" re-labeling in the
#    fleet-aggregated export, Chrome traces stamp process_index as pid.
OBS_SCHEMA_VERSION = 3

__all__ = ["OBS_SCHEMA_VERSION"]
