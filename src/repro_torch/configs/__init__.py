"""Architecture configs of the LM substrate (copies of ``repro/configs``)."""
