"""Ray-sampling, compositing and grid-sampling operations of the port."""
