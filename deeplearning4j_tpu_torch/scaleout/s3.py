"""Cloud object-store adapters (optional-dependency S3 shims).

Counterpart of deeplearning4j_tpu/scaleout/s3.py (parity surface: the
reference's deeplearning4j-aws S3Downloader and S3Uploader): bucket
listing, object download into the local cache, file and directory upload,
behind a small ``ObjectStore`` protocol. ``LocalFileStore`` is a directory
tree (the air-gapped and test implementation), ``S3ObjectStore`` adapts
the optional ``boto3`` dependency (gated at construction), and
``download_dataset`` drops objects into the fetcher cache
(``data.fetchers.data_dir()``) so the standard loaders pick them up.
Transient store failures retry through ``resilience.retry``. Host code
only.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import List, Optional


class ObjectStore:
    """get/put/list over <bucket>/<key> namespaces."""

    def list_objects(self, bucket: str, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def download(self, bucket: str, key: str, local_path) -> Path:
        raise NotImplementedError

    def upload(self, local_path, bucket: str, key: str) -> None:
        raise NotImplementedError

    def delete(self, bucket: str, key: str) -> None:
        raise NotImplementedError


class LocalFileStore(ObjectStore):
    """Directory-backed store: <root>/<bucket>/<key>. The contract-test
    double, and a real choice for on-prem shared filesystems."""

    def __init__(self, root):
        self.root = Path(root)

    def _p(self, bucket: str, key: str = "") -> Path:
        return self.root / bucket / key

    def list_objects(self, bucket: str, prefix: str = "") -> List[str]:
        base = self._p(bucket)
        if not base.is_dir():
            return []
        return sorted(str(p.relative_to(base)) for p in base.rglob("*")
                      if p.is_file()
                      and str(p.relative_to(base)).startswith(prefix))

    def download(self, bucket: str, key: str, local_path) -> Path:
        src = self._p(bucket, key)
        if not src.exists():
            raise FileNotFoundError(f"s3://{bucket}/{key} (at {src})")
        local_path = Path(local_path)
        local_path.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, local_path)
        return local_path

    def upload(self, local_path, bucket: str, key: str) -> None:
        dst = self._p(bucket, key)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(local_path, dst)

    def delete(self, bucket: str, key: str) -> None:
        p = self._p(bucket, key)
        if p.exists():
            p.unlink()


class S3ObjectStore(ObjectStore):
    """boto3-backed store (optional dependency, gated at construction)."""

    def __init__(self, **session_kwargs):
        try:
            import boto3
        except ImportError as e:
            raise ImportError(
                "S3 transport needs the optional 'boto3' package "
                "(pip install boto3), or use LocalFileStore / any "
                "ObjectStore.") from e
        self._s3 = boto3.session.Session(**session_kwargs).client("s3")

    def list_objects(self, bucket: str, prefix: str = "") -> List[str]:
        out, token = [], None
        while True:
            kw = {"Bucket": bucket, "Prefix": prefix}
            if token:
                kw["ContinuationToken"] = token
            resp = self._s3.list_objects_v2(**kw)
            out.extend(o["Key"] for o in resp.get("Contents", []))
            if not resp.get("IsTruncated"):
                return out
            token = resp.get("NextContinuationToken")

    def download(self, bucket: str, key: str, local_path) -> Path:
        local_path = Path(local_path)
        local_path.parent.mkdir(parents=True, exist_ok=True)
        self._s3.download_file(bucket, key, str(local_path))
        return local_path

    def upload(self, local_path, bucket: str, key: str) -> None:
        self._s3.upload_file(str(local_path), bucket, key)

    def delete(self, bucket: str, key: str) -> None:
        self._s3.delete_object(Bucket=bucket, Key=key)


class S3Downloader:
    """Parity: aws/s3/reader/S3Downloader — pull objects (or whole
    prefixes) down; ``download_dataset`` lands them in the fetcher cache so
    load_mnist/load_cifar10 switch from synthetic to real data."""

    def __init__(self, store: Optional[ObjectStore] = None,
                 retry_policy=None):
        from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy
        self.store = store if store is not None else S3ObjectStore()
        # transient store failures (throttling, connection resets) back off
        # under the shared primitive; FileNotFoundError stays fatal
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=4, base_delay=0.1, max_delay=5.0)

    def download(self, bucket: str, key: str, local_path) -> Path:
        from deeplearning4j_tpu_torch.resilience.retry import retry_call
        return retry_call(self.store.download, bucket, key, local_path,
                          policy=self.retry_policy, component="fetcher")

    def download_prefix(self, bucket: str, prefix: str, local_dir) -> List[Path]:
        """Download every object under ``prefix`` into ``local_dir``,
        stripping the prefix only at a ``/`` boundary: S3 prefixes are
        plain character prefixes, so listing prefix ``data`` also returns
        ``database/x.txt`` — that key keeps its full path locally instead
        of being mangled to ``base/x.txt``."""
        local_dir = Path(local_dir)
        p = prefix.rstrip("/")
        out = []
        for key in self.store.list_objects(bucket, prefix):
            if not p:
                rel = key
            elif key == p:
                rel = Path(key).name
            elif key.startswith(p + "/"):
                rel = key[len(p) + 1:]
            else:          # char-prefix match past the / boundary
                rel = key
            out.append(self.download(bucket, key, local_dir / rel))
        return out

    def download_dataset(self, bucket: str, prefix: str,
                         dataset_name: str) -> List[Path]:
        from deeplearning4j_tpu_torch.data.fetchers import data_dir
        return self.download_prefix(bucket, prefix,
                                    data_dir() / dataset_name)


class S3Uploader:
    """Parity: aws/s3/uploader/S3Uploader — push a file or directory."""

    def __init__(self, store: Optional[ObjectStore] = None):
        self.store = store if store is not None else S3ObjectStore()

    def upload_file(self, local_path, bucket: str, key: str) -> None:
        self.store.upload(local_path, bucket, key)

    def upload_dir(self, local_dir, bucket: str, prefix: str = "") -> int:
        local_dir = Path(local_dir)
        n = 0
        for p in sorted(local_dir.rglob("*")):
            if p.is_file():
                rel = p.relative_to(local_dir)
                key = f"{prefix.rstrip('/')}/{rel}" if prefix else str(rel)
                self.store.upload(p, bucket, key)
                n += 1
        return n
