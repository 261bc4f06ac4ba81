"""Performance model: per-device op counts of a step (:mod:`.opcount`),
the three-term roofline on an H100 (:mod:`.roofline`), a per-op breakdown
(:mod:`.breakdown`) and the BottleMod step model (:mod:`.stepmodel`)."""
