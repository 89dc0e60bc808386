"""Architecture configs of the port (copies of ``repro/configs``): the shape
cells and the bi-encoder's config. The registry waits for the model zoo,
since it imports every family."""
