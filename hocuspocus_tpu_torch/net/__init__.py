"""The RESP (Redis protocol) client and subscriber the Redis extension
uses, and an in-process mini-redis (`net.mini_redis`) for tests and
single-host deployments. A copy of the JAX package's `net/`."""

from .resp import RedisClient, RedisSubscriber

__all__ = ["RedisClient", "RedisSubscriber"]
