"""Architecture configs of the port (copies of ``repro/configs``): the shape
cells, the bi-encoder's config and its training step. The registry waits
for the model zoo, since it imports every family."""
