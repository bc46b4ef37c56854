"""fakepta_tpu_torch.serve: the serving layer, in part (port of
``fakepta_tpu.serve``).

Ported so far: the declarative :class:`ArraySpec` and the
:class:`ServeError` family (:mod:`.spec`). The warm pool, the scheduler,
the fleet and the request dataclasses are ROADMAP Queue 1 items 11b.3 and
11b.4.
"""

from .spec import (DEFAULT_BUCKETS, ArraySpec, ServeBusy, ServeClosed,
                   ServeError, ServeTimeout)

__all__ = ["DEFAULT_BUCKETS", "ArraySpec", "ServeBusy", "ServeClosed",
           "ServeError", "ServeTimeout"]
