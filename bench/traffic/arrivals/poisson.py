"""poisson: independent arrivals, exponential gaps at the mean rate."""


def gaps(rng, rate: float, n: int, law: dict):
    return rng.exponential(1.0 / rate, size=n)
