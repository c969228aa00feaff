"""S3 persistence extension (reference `extension-s3`).

Stores each document at `{prefix}{documentName}.bin`. Instead of the AWS
SDK the reference uses, this ships a minimal async S3 REST client with
SigV4 signing over aiohttp (imported by the methods that make a request,
so importing the extension needs none) — self-contained, testable against any
S3-compatible endpoint (MinIO, fakes).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
from typing import Optional
from urllib.parse import quote

from ..server.types import Payload
from .database import Database


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3Client:
    """Tiny SigV4 S3 client: get_object / put_object / head_bucket."""

    def __init__(
        self,
        bucket: str,
        region: str = "us-east-1",
        endpoint: Optional[str] = None,
        access_key_id: Optional[str] = None,
        secret_access_key: Optional[str] = None,
        force_path_style: bool = True,
    ) -> None:
        self.bucket = bucket
        self.region = region
        self.endpoint = (endpoint or f"https://s3.{region}.amazonaws.com").rstrip("/")
        self.access_key_id = access_key_id or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_access_key = secret_access_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", ""
        )
        self.force_path_style = force_path_style

    def _url_and_path(self, key: str) -> tuple[str, str]:
        path = f"/{self.bucket}/{quote(key)}" if self.force_path_style else f"/{quote(key)}"
        return f"{self.endpoint}{path}", path

    def _headers(self, method: str, path: str, payload: bytes, host: str) -> dict:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        date_stamp = now.strftime("%Y%m%d")
        payload_hash = hashlib.sha256(payload).hexdigest()
        canonical_headers = f"host:{host}\nx-amz-content-sha256:{payload_hash}\nx-amz-date:{amz_date}\n"
        signed_headers = "host;x-amz-content-sha256;x-amz-date"
        canonical_request = (
            f"{method}\n{path}\n\n{canonical_headers}\n{signed_headers}\n{payload_hash}"
        )
        scope = f"{date_stamp}/{self.region}/s3/aws4_request"
        string_to_sign = (
            f"AWS4-HMAC-SHA256\n{amz_date}\n{scope}\n"
            f"{hashlib.sha256(canonical_request.encode()).hexdigest()}"
        )
        k_date = _sign(f"AWS4{self.secret_access_key}".encode(), date_stamp)
        k_region = hmac.new(k_date, self.region.encode(), hashlib.sha256).digest()
        k_service = hmac.new(k_region, b"s3", hashlib.sha256).digest()
        k_signing = hmac.new(k_service, b"aws4_request", hashlib.sha256).digest()
        signature = hmac.new(k_signing, string_to_sign.encode(), hashlib.sha256).hexdigest()
        authorization = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key_id}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"
        )
        return {
            "Authorization": authorization,
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
        }

    async def get_object(self, key: str) -> Optional[bytes]:
        import aiohttp

        url, path = self._url_and_path(key)
        host = url.split("//", 1)[1].split("/", 1)[0]
        headers = self._headers("GET", path, b"", host)
        async with aiohttp.ClientSession() as session:
            async with session.get(url, headers=headers) as response:
                if response.status == 404:
                    return None
                response.raise_for_status()
                return await response.read()

    async def put_object(self, key: str, data: bytes) -> None:
        import aiohttp

        url, path = self._url_and_path(key)
        host = url.split("//", 1)[1].split("/", 1)[0]
        headers = self._headers("PUT", path, data, host)
        async with aiohttp.ClientSession() as session:
            async with session.put(url, data=data, headers=headers) as response:
                response.raise_for_status()

    async def head_bucket(self) -> bool:
        import aiohttp

        path = f"/{self.bucket}" if self.force_path_style else "/"
        url = f"{self.endpoint}{path}"
        host = url.split("//", 1)[1].split("/", 1)[0]
        headers = self._headers("HEAD", path, b"", host)
        async with aiohttp.ClientSession() as session:
            async with session.head(url, headers=headers) as response:
                return response.status < 400


class S3(Database):
    def __init__(
        self,
        bucket: str,
        region: str = "us-east-1",
        prefix: str = "",
        endpoint: Optional[str] = None,
        access_key_id: Optional[str] = None,
        secret_access_key: Optional[str] = None,
        client: Optional[S3Client] = None,
        force_path_style: bool = True,
    ) -> None:
        super().__init__(fetch=self._fetch, store=self._store)
        self.prefix = prefix
        self.client = client or S3Client(
            bucket=bucket,
            region=region,
            endpoint=endpoint,
            access_key_id=access_key_id,
            secret_access_key=secret_access_key,
            force_path_style=force_path_style,
        )

    def object_key(self, document_name: str) -> str:
        return f"{self.prefix}{document_name}.bin"

    async def on_configure(self, data: Payload) -> None:
        try:
            await self.client.head_bucket()
        except Exception as error:
            from ..server import logger

            logger.log_error(f"S3 connection probe failed: {error}")

    async def _fetch(self, data: Payload) -> Optional[bytes]:
        return await self.client.get_object(self.object_key(data.document_name))

    async def _store(self, data: Payload) -> None:
        await self.client.put_object(self.object_key(data.document_name), data["state"])
