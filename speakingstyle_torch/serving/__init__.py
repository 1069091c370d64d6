"""Text -> wav serving on one engine (JAX counterpart:
speakingstyle_tpu/serving/).

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
  server.py    -- the stdlib HTTP front end

The fleet router, the cluster and the long-form tiers are ROADMAP.md
queue A items 5b and 5c.
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
