"""The tuner: parameter spaces, the estimation loop, GP surrogates,
EHVI / mEHVI and the tuning loop (``fastpgt.tune``)."""
