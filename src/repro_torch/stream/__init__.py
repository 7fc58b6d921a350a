"""Online streaming training (the port of ``src/repro/stream/``): live
ingestion into a device-resident ring, train-on-recent rounds, and the
train/serve freshness loop.

* :mod:`repro_torch.stream.sources` — the
  :class:`~repro_torch.stream.sources.InteractionStream` protocol, a seeded
  synthetic generator with drifting popularity, a JSONL replay log and a
  probe splicer, all seekable (numpy only: events equal the reference's);
* ``DeviceCFDataset.apply_events`` / ``stream_ring_dataset`` /
  ``stream_batch_device`` (:mod:`repro_torch.data.pipeline`) — the ring;
* :mod:`repro_torch.stream.service` —
  :class:`~repro_torch.stream.service.StreamingTrainer`, the ingest →
  train → refresh loop with round-edge checkpoints of the cursor and ring.
"""
from repro_torch.stream.service import StreamingConfig, StreamingTrainer
from repro_torch.stream.sources import (EventBatch, InteractionStream,
                                        ProbeInjector, ReplayLogStream,
                                        SyntheticStream, record_stream)

__all__ = [
    "EventBatch", "InteractionStream", "ProbeInjector", "ReplayLogStream",
    "SyntheticStream", "record_stream",
    "StreamingConfig", "StreamingTrainer",
]
