"""Server extensions: persistence (Database, SQLite, IncrementalSQLite,
S3), Redis fan-out across instances, webhooks, version history, logging
and connection throttling, with the storage plane's `Durability`.

A copy of the JAX package's `extensions/`. aiohttp is imported only by
the Webhook and S3 calls that make a request, so importing this package
needs none.
"""

from ..storage import Durability
from .database import Database
from .history import History
from .incremental import IncrementalSQLite
from .logger import Logger
from .redis import Redis
from .s3 import S3, S3Client
from .sqlite import SQLite
from .throttle import Throttle
from .webhook import Events, Webhook

__all__ = [
    "Database",
    "Durability",
    "History",
    "IncrementalSQLite",
    "Logger",
    "Redis",
    "S3",
    "S3Client",
    "SQLite",
    "Throttle",
    "Events",
    "Webhook",
]
