"""The page-streaming layer: paging geometry, the StreamPlan IR, the
memory modes, the page store and the layer streamer, and the
simulator's scenarios."""
