"""gamma: bursty arrivals, gamma gaps at the mean rate with the coefficient
of variation ``cv`` (1 is Poisson's; above 1 the arrivals come in bursts
with long lulls between them)."""


def gaps(rng, rate: float, n: int, law: dict):
    k = 1.0 / law["cv"] ** 2
    return rng.gamma(k, 1.0 / (rate * k), size=n)
