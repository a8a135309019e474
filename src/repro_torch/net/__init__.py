"""Network front door for the port's readout server.

``protocol``  — the versioned little-endian binary wire format
                (FrameBatch ingest, sparse TriggerBatch egress, CRC32
                framing, strict named-error decoder with resync), byte
                for byte the JAX package's.
``ingress``   — asyncio multi-producer TCP/UDP front door feeding one
                ``ReadoutServer`` through a bounded drop-and-count queue.
``replay``    — closed-loop replay client: streams recorded smartpixel
                frames at controlled Poisson/square-wave rates and
                verifies returned trigger decisions bit-exact against a
                host oracle.
"""
