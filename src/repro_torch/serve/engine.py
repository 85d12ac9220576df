"""Transactional publish for serving workers (port of the part of
``repro.serve.engine`` that the LM serving group needs).

:class:`TxnOutputPublisher` is the JAX package's class with its text
kept: outputs and the input offsets they answer commit in one
transaction on a :class:`~repro_torch.core.cluster.BrokerCluster`. It
is host code and touches no device. The rest of the JAX module
(``build_serve_step``, ``InferenceReplica``, ``InferenceDeployment``)
belongs to the paper loop and is not ported yet.
"""

from __future__ import annotations

from repro_torch.core.cluster import ClusterProducer, InvalidTxnState
from repro_torch.core.log import ProducerFenced

__all__ = ["TxnOutputPublisher"]


class TxnOutputPublisher:
    """Transactional produce-and-commit for one consumer-group worker.

    Wraps the exactly-once publish pattern of DESIGN.md §8: outputs and
    the input offsets they were computed from commit in ONE transaction,
    so a worker crash between "produce outputs" and "commit offsets" can
    neither re-serve a polled batch (duplicates downstream) nor drop
    one. The worker owns a stable transactional id — re-creating the
    publisher fences its zombie. Shared by :class:`InferenceReplica`
    and the LM serving workers (:mod:`repro.serve.lm_engine`).
    """

    def __init__(self, log, consumer, member_id: str, transactional_id: str):
        self.log = log
        self.consumer = consumer
        self.member_id = member_id
        self.producer = ClusterProducer(log, transactional_id=transactional_id)

    def txn_aborted(self) -> bool:
        """Whether the producer's current/last transaction is (or will
        be) aborted — drives whether local positions must rewind. A
        durably-decided COMMIT means the positions stand: rewinding them
        would re-deliver (and re-publish) a batch the commit covers."""
        st = self.log.txn_state(self.producer.producer_id)
        return st not in ("prepare_commit", "complete_commit")

    def recover_txn(self) -> bool:
        """Resolve a transaction a previous tick left behind (commit or
        abort raised mid-flight) before starting a new one. Returns True
        when it ended in an abort — local positions were rewound, so the
        CURRENT tick's computed outputs must be discarded too (their
        source records re-deliver at the next poll; publishing them now
        would commit outputs whose offsets were just reset)."""
        prod = self.producer
        try:
            prod.abort_txn()
            self.consumer.reset_positions()
            return True
        except (InvalidTxnState, ProducerFenced):
            pass  # outcome already decided (or we were fenced)
        except Exception:
            pass  # quorum window: outcome still open, try again next tick
        if self.txn_aborted():
            self.consumer.reset_positions()
            return True
        # commit durably decided: finish it (at the transaction's own
        # recorded epoch) so the committed offsets reflect the previous
        # tick's work before the next poll
        try:
            self.log.resolve_txn(prod.producer_id)
        except Exception:
            pass  # controller_tick recovery finishes it
        return False

    def publish(
        self,
        topic: str,
        batches: list[list[bytes]],
        keys: list[list[bytes]] | None = None,
    ) -> int:
        """Produce ``batches`` and commit the consumer's polled offsets
        in one transaction. With ``keys`` (parallel structure to
        ``batches``) records route by key hash — per-tenant partitioning
        — via per-record sends; without, each batch lands on partition 0
        in one append. Returns records published, or 0 when the tick
        must be discarded (recovery rewound positions, or the group
        moved on mid-compute)."""
        prod = self.producer
        if prod.in_txn:
            if self.recover_txn():
                return 0  # positions rewound: this tick's outs re-derive
            if prod.in_txn:
                return 0  # still unresolved (no quorum): skip this tick
        if not batches:
            return 0  # nothing polled: nothing to publish or commit
        self.log.ensure_topic(topic)
        prod.begin_txn()
        try:
            done = 0
            for i, out in enumerate(batches):
                if keys is None:
                    prod.send_batch(topic, out, partition=0)
                else:
                    # send_batch routes the whole batch by keys[0]; keyed
                    # records must fan out per-record to partition by key
                    for v, k in zip(out, keys[i]):
                        prod.send(topic, v, key=k)
                done += len(out)
            group = self.consumer.group
            if (
                self.member_id not in group.members
                or group.generation != self.consumer.generation
            ):
                # the group moved on while we computed (stall → eviction
                # → rebalance): committing these offsets would rewind the
                # new owner. Abort — the aborted outputs are invisible,
                # and the new owner re-serves the batch. (Best-effort
                # fence, same shape as commit_member's generation check;
                # the generation-atomic variant is the KIP-447 follow-up
                # in ROADMAP.)
                prod.abort_txn()
                self.consumer.reset_positions()
                return 0
            prod.send_offsets_to_txn(group.group_id, self.consumer.positions())
            prod.commit_txn()
        except BaseException:
            try:
                prod.abort_txn()
            except Exception:
                pass  # decided or quorum-blocked: resolved below / next tick
            if self.txn_aborted():
                # the abort un-published this tick's work: rewind to the
                # committed offsets so the next poll re-delivers it
                self.consumer.reset_positions()
            raise
        return done

