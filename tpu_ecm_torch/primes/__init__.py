from .sieve import primes_range, PrimeStream, PRIME_RANGE  # noqa: F401
