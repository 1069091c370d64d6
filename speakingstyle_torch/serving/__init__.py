"""Text -> wav serving on one engine or a fleet of replica engines (JAX
counterpart: speakingstyle_tpu/serving/).

Layering:
  lattice.py   -- the (batch, L_src, T_mel) bucket grid, and the style
                  encoder's (batch, ref_len) StyleLattice
  style.py     -- the reference-encoder programs behind a content-addressed
                  (gamma, beta) cache (POST /styles backs onto it)
  engine.py    -- the prepared programs (a CUDA graph per point on the card)
                  and the padded dispatch
  batcher.py   -- admission queue, deadline coalescing, per-request futures
  frontend.py  -- G2P, speakers and style resolution, and its worker pool
  streaming.py -- overlap-trimmed wav windows over the vocoder lattice
  resilience.py -- the structured failures and the replica circuit breaker
  fleet.py     -- N replica engines behind one EDF admission queue, with
                  supervision, re-warm and the rollout surface
  lifecycle.py -- the canary-gated rolling rollout
  autoscale.py -- the policy thread that drives the fleet's scale_to()
  tiers.py     -- class -> quality-tier routing over canary-gated tier fleets
  probes.py    -- golden probes of the live fleet against pinned anchors
  longform.py  -- chapter-length requests: deadline-sharing chunk groups,
                  or one ring-attention free run (RingTier)
  ring_ranks.py -- the helper rank processes of a ring tier
  traffic.py   -- the seeded diurnal / flash-crowd load model
  cluster.py   -- replica processes behind the router: leases, the hedged
                  wire dispatch, metrics and trace federation
  server.py    -- the stdlib HTTP front end over the batcher or a router

The package exports what the JAX package's does (the fleet's and the
cluster's modules are imported by name).
"""

from speakingstyle_torch.serving.batcher import (  # noqa: F401
    ContinuousBatcher,
    Overloaded,
    ShutdownError,
)
from speakingstyle_torch.serving.engine import (  # noqa: F401
    SynthesisEngine,
    SynthesisRequest,
    SynthesisResult,
)
from speakingstyle_torch.serving.lattice import (  # noqa: F401
    Bucket,
    BucketLattice,
    RequestTooLarge,
    StyleLattice,
)
from speakingstyle_torch.serving.style import (  # noqa: F401
    StyleService,
    StyleVectors,
)
