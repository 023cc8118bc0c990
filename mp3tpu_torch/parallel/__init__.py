"""Many clips and many ranks (port of mp3tpu/parallel).

``corpus``: independent clips, batched as extra channel lanes on one
device (``encode_corpus_batched``) or split into contiguous shares over
processes (``init_distributed``, ``local_share``, ``encode_corpus``).
``sharding`` and ``clip``: one clip cut along its granule axis over the
ranks of a ``torch.distributed`` device mesh.  ``dryrun``: both
multi-rank paths on a small input.
"""
